// K7: separable 3D Gaussian blur with zero borders.
//
// Replaces the Pallas kernel sift3d/kernels/gauss_pallas.py: blur3d_pallas
// (_blur_kernel). Same result: out = Z(Y(X(v))) for each volume of a
// contiguous f32 [B, Z, Y, X] batch, x pass first, each pass rounded to f32,
// taps outside the volume absent (zero padding).
//
// The arithmetic is fixed: output o of an axis pass is the fused
// multiply-add chain
//   acc = 0; for i = max(0, o - r) .. min(n - 1, o + r) ascending:
//     acc = fma(taps[i - o + r], v[i], acc)
// which is what the plain version (sift3d_torch.kernels.gauss.blur3d, a
// banded matmul) computes on the CPU, bit for bit (except where y and x are
// both small, as in a 5x6x5 volume, whose y pass the CPU matmul sums in
// another order), and what makes a blur of Z-sharded halo slabs equal the
// whole-volume blur. The library is built
// with -fmad=false, so every fused multiply-add here is the explicit
// __fmaf_rn, and every chain runs over its taps in ascending input index.
//
// What bounds it on an H100: device memory at the bound: a fused blur reads
// each voxel once and writes it once (57.8 MB for a 182x218x182 level, 462
// MB for the doubled 364x436x364 grid), and at most 3 x 17 FMAs a voxel are
// far below the f32 rate. In practice, latency: the first design (8 x 32
// tiles, each block walking the z planes of a run with the z chain read
// back from a ring of xy planes in shared memory, 3 blocks an SM) ran at
// about 280 GB/s, each block waiting on its own planes between two barriers
// a plane. Keeping its plane walk with the z chains in registers and a
// cp.async ring did not change that (0.30-0.35 ms for the T1 level-5 blur
// on an H100 80GB HBM3 at 700 W: too few blocks in flight, too much work
// between barriers).
//
// Design: no plane walk, two launches. (1) x and y: a block of 32 x 8
// threads blurs one 32-column x (8 * RY)-row tile of one plane (RY = 1, 2,
// 4 or 8): it loads the tile with its x/y halo into shared memory, runs the
// x pass on the tile's rows and halo rows (a thread four adjacent outputs
// from float4 reads: 1.25 shared loads an output at r = 8, not 17), then
// each thread streams its window of rows once into its RY y chains. Thousands of independent
// blocks keep the memory busy. (2) z: each thread loads SEG + 2r planes of
// one (y, x) column into registers and writes SEG outputs. The xy result
// makes one round trip through memory (on the T1 grid mostly through the
// 50 MB L2). Batches of small volumes (Z <= 16, Y * X <= 256: the BRIEF
// pre-blur's and the histogram blur's 11^3) are blurred whole in shared
// memory instead, several to a 256-thread block, one thread per (y, x)
// column: x pass, y pass, then the z pass from the column's registers, each
// output common.cuh's blur_chain (the fused BRIEF kernel's pre-blur too). The
// radius, RY and SEG are template parameters, the taps a kernel parameter
// (constant bank). The launch geometry is chosen per shape by
// sift3d_torch.kernels.gauss_cuda.blur_launch_geometry.

#include "common.cuh"

namespace {

constexpr int MAX_R = sift3d::kBlurMaxR;
constexpr int TX = 32;     // xy tile columns, one per thread
constexpr int ROWS = 8;    // thread rows of a block
constexpr int THREADS = TX * ROWS;
constexpr int SMALL_Z = 16;
constexpr int SMALL_COLS = THREADS;

using Taps = sift3d::BlurTaps;

// x pass of four adjacent outputs c0 .. c0 + 3 of one tile row (row: the
// row's first halo column, 16-byte aligned): the inputs come in as float4s,
// and each output is the chain over the taps whose input column is in the
// volume (CHECK false when the whole tile's halo is inside it)
template <int R, bool CHECK>
__device__ __forceinline__ float4 x_chain4(const float* __restrict__ row, const Taps& taps,
                                           int c0, int gx0, int X) {
  constexpr int NV = (4 + 2 * R + 3) / 4;  // float4s covering 4 + 2R inputs
  float v[4 * NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const float4 q = reinterpret_cast<const float4*>(row + c0)[m];
    v[4 * m] = q.x;
    v[4 * m + 1] = q.y;
    v[4 * m + 2] = q.z;
    v[4 * m + 3] = q.w;
  }
  float acc[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    acc[o] = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * R + 1; ++k) {
      const int xi = gx0 + o - R + k;
      if (!CHECK || (xi >= 0 && xi < X)) acc[o] = __fmaf_rn(taps.t[k], v[o + k], acc[o]);
    }
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <int R, int RY>
__global__ void __launch_bounds__(THREADS)
blur_xy_kernel(const float* __restrict__ in, float* __restrict__ out, Taps taps, int Y, int X,
               int x_tiles) {
  constexpr int NT = 2 * R + 1;
  constexpr int TY = ROWS * RY;
  constexpr int HW = TX + 2 * R;
  constexpr int HWP = (HW + 3) / 4 * 4 + 4;  // row stride: float4-aligned, room for the last float4
  constexpr int HH = TY + 2 * R;
  __shared__ __align__(16) float tile[HH][HWP];   // input tile with its x/y halo
  __shared__ __align__(16) float xpass[HH][TX];   // x-blurred rows, y halo included
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  // blockIdx.x enumerates (plane of the batch, x tile), x tile fastest
  const long long plane = blockIdx.x / x_tiles;
  const int x0 = (int)(blockIdx.x % x_tiles) * TX, y0 = blockIdx.y * TY;
  const float* src = in + plane * Y * X;
  float* dst = out + plane * Y * X;
  for (int e = tid; e < HH * HW; e += THREADS) {
    const int yy = y0 - R + e / HW, xx = x0 - R + e % HW;
    tile[e / HW][e % HW] = yy >= 0 && yy < Y && xx >= 0 && xx < X ? src[(long long)yy * X + xx] : 0.0f;
  }
  __syncthreads();
  const int gx = x0 + tx;
  const bool interior_x = x0 - R >= 0 && x0 + TX + R <= X;
  // x pass: 8 threads a row, each four adjacent outputs
  for (int hy = tid / (TX / 4); hy < HH; hy += THREADS / (TX / 4)) {
    const int c0 = 4 * (tid % (TX / 4));
    reinterpret_cast<float4*>(&xpass[hy][c0])[0] =
        interior_x ? x_chain4<R, false>(tile[hy], taps, c0, x0 + c0, X)
                   : x_chain4<R, true>(tile[hy], taps, c0, x0 + c0, X);
  }
  __syncthreads();
  // y pass: input row q of this thread's window feeds output row r with
  // tap q - r, in ascending q
  const int ry0 = ty * RY;
  float yv[RY];
#pragma unroll
  for (int r = 0; r < RY; ++r) yv[r] = 0.0f;
#pragma unroll
  for (int q = 0; q < RY + 2 * R; ++q) {
    const int yi = y0 + ry0 - R + q;
    if (yi >= 0 && yi < Y) {
      const float v = xpass[ry0 + q][tx];
#pragma unroll
      for (int r = 0; r < RY; ++r)
        if (q - r >= 0 && q - r < NT) yv[r] = __fmaf_rn(taps.t[q - r], v, yv[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RY; ++r)
    if (gx < X && y0 + ry0 + r < Y) dst[(long long)(y0 + ry0 + r) * X + gx] = yv[r];
}

template <int R>
__global__ void __launch_bounds__(THREADS)
blur3d_small_kernel(const float* __restrict__ in, float* __restrict__ out, Taps taps, int B,
                    int Z, int Y, int X, int vpb) {
  __shared__ float buf[SMALL_Z * SMALL_COLS];  // vpb whole volumes
  const int tid = threadIdx.x;
  const int cols = Y * X, vox = Z * cols;
  const int b0 = blockIdx.x * vpb;
  const int nvol = min(vpb, B - b0);
  const size_t base = (size_t)b0 * vox;
  for (int e = tid; e < nvol * vox; e += THREADS) buf[e] = in[base + e];
  const int vb = tid / cols, col = tid % cols;
  const bool active = vb < nvol;
  const int y = col / X, x = col % X;
  float* vol = buf + (active ? vb * vox : 0);
  float r[SMALL_Z];
  __syncthreads();
  if (active) {  // x pass
#pragma unroll
    for (int z = 0; z < SMALL_Z; ++z)
      if (z < Z) r[z] = sift3d::blur_chain<R>(taps, x, X, [&](int i) { return vol[(z * Y + y) * X + i]; });
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int z = 0; z < SMALL_Z; ++z)
      if (z < Z) vol[(z * Y + y) * X + x] = r[z];
  }
  __syncthreads();
  if (!active) return;
#pragma unroll
  for (int z = 0; z < SMALL_Z; ++z)  // y pass
    if (z < Z) r[z] = sift3d::blur_chain<R>(taps, y, Y, [&](int i) { return vol[(z * Y + i) * X + x]; });
  float* dst = out + base + (size_t)vb * vox + col;
  // z pass from the column's registers (Z <= SMALL_Z: the guard only keeps
  // the unrolled indices inside the array)
#pragma unroll
  for (int z = 0; z < SMALL_Z; ++z)
    if (z < Z)
      dst[(size_t)z * cols] =
          sift3d::blur_chain<R>(taps, z, Z, [&](int i) { return i < SMALL_Z ? r[i] : 0.0f; });
}

// The z pass: the batch viewed as [B, Z, inner = Y * X]. A thread loads
// SEG + 2R inputs of one z column into registers and writes SEG outputs; a
// block is blockDim.x consecutive inner indices by blockDim.y segments.
template <int R, int SEG>
__global__ void __launch_bounds__(THREADS)
blur_col_kernel(const float* __restrict__ in, float* __restrict__ out, Taps taps, int N,
                long long inner, int inner_blocks, int n_seg) {
  constexpr int NT = 2 * R + 1, W = SEG + 2 * R;
  const long long outer = blockIdx.x / inner_blocks;
  const long long i = (long long)(blockIdx.x % inner_blocks) * blockDim.x + threadIdx.x;
  const int seg = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= inner || seg >= n_seg) return;
  const int s0 = seg * SEG;
  const float* src = in + outer * N * inner + i;
  float* dst = out + outer * N * inner + i;
  float v[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int n = s0 - R + q;
    v[q] = n >= 0 && n < N ? src[(long long)n * inner] : 0.0f;
  }
  if (s0 - R >= 0 && s0 + SEG + R <= N) {
#pragma unroll
    for (int o = 0; o < SEG; ++o) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NT; ++k) acc = __fmaf_rn(taps.t[k], v[o + k], acc);
      dst[(long long)(s0 + o) * inner] = acc;
    }
  } else {
#pragma unroll
    for (int o = 0; o < SEG; ++o) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const int n = s0 + o - R + k;
        if (n >= 0 && n < N) acc = __fmaf_rn(taps.t[k], v[o + k], acc);
      }
      if (s0 + o < N) dst[(long long)(s0 + o) * inner] = acc;
    }
  }
}

// geom: {kind, vpb, ry, seg, block x, block y}: kind 0 small (vpb volumes a
// block), 1 xy + z (xy tiles of 8 * ry rows; the z pass's outputs a thread
// and block shape), from sift3d_torch.kernels.gauss_cuda.blur_launch_geometry
template <int R>
int launch_xy(const float* in, float* out, const Taps& taps, int B, int Z, int Y, int X, int ry,
              int device, void* stream) {
  const int x_tiles = (X + TX - 1) / TX;
  const dim3 grid((unsigned)((long long)B * Z * x_tiles), (Y + ROWS * ry - 1) / (ROWS * ry));
  // a pointer, so the template's comma stays out of the launch macro
  void (*kernel)(const float*, float*, Taps, int, int, int) =
      ry == 1   ? blur_xy_kernel<R, 1>
      : ry == 2 ? blur_xy_kernel<R, 2>
      : ry == 4 ? blur_xy_kernel<R, 4>
      : ry == 8 ? blur_xy_kernel<R, 8>
                : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  SIFT3D_LAUNCH(device, kernel, grid, dim3(TX, ROWS), stream, in, out, taps, Y, X, x_tiles);
}

template <int R>
int launch_z(const float* in, float* out, const Taps& taps, int B, int Z, long long inner,
             const int* g, int device, void* stream) {
  const int seg = g[0], bx = g[1], by = g[2];
  if (bx < 1 || by < 1 || bx * by > THREADS) return (int)cudaErrorInvalidValue;
  const int inner_blocks = (int)((inner + bx - 1) / bx);
  const int n_seg = (Z + seg - 1) / seg;
  const dim3 grid((unsigned)((long long)B * inner_blocks), (n_seg + by - 1) / by), block(bx, by);
  void (*kernel)(const float*, float*, Taps, int, long long, int, int) =
      seg == 16 ? blur_col_kernel<R, 16> : (seg == 4 ? blur_col_kernel<R, 4> : nullptr);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  SIFT3D_LAUNCH(device, kernel, grid, block, stream, in, out, taps, Z, inner, inner_blocks, n_seg);
}

template <int R>
int launch(const float* in, float* out, float* tmp, const Taps& taps, int B, int Z, int Y, int X,
           const int* geom, int device, void* stream) {
  if (geom[0] == 0) {
    const int vpb = geom[1];
    if (vpb < 1 || Z > SMALL_Z || vpb * Y * X > SMALL_COLS) return (int)cudaErrorInvalidValue;
    const dim3 grid((B + vpb - 1) / vpb);
    SIFT3D_LAUNCH(device, blur3d_small_kernel<R>, grid, dim3(THREADS), stream, in, out, taps, B,
                  Z, Y, X, vpb);
  }
  if (geom[0] != 1) return (int)cudaErrorInvalidValue;
  const int err = launch_xy<R>(in, tmp, taps, B, Z, Y, X, geom[2], device, stream);
  return err != 0 ? err : launch_z<R>(tmp, out, taps, B, Z, (long long)Y * X, geom + 3, device, stream);
}

}  // namespace

// in, out, tmp: [B, Z, Y, X] f32 on the device (distinct buffers; tmp holds
// the xy pass); taps: 2r + 1 f32 and geom: 6 ints (see launch), both in
// host memory; r in [1, 8].
extern "C" int sift3d_blur3d(const float* in, float* out, float* tmp, const float* taps_host,
                             const int* geom, int r, int B, int Z, int Y, int X, int device,
                             void* stream) {
  if (r < 1 || r > MAX_R) return (int)cudaErrorInvalidValue;
  Taps taps = {};
  for (int k = 0; k < 2 * r + 1; ++k) taps.t[k] = taps_host[k];
  switch (r) {
    case 1: return launch<1>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
    case 2: return launch<2>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
    case 3: return launch<3>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
    case 4: return launch<4>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
    case 5: return launch<5>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
    case 6: return launch<6>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
    case 7: return launch<7>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
    default: return launch<MAX_R>(in, out, tmp, taps, B, Z, Y, X, geom, device, stream);
  }
}
