// K7: fused separable 3D Gaussian blur with zero borders.
//
// Replaces the Pallas kernel sift3d/kernels/gauss_pallas.py: blur3d_pallas
// (_blur_kernel). Same result: out = Z(Y(X(v))) for each volume of a
// contiguous f32 [B, Z, Y, X] batch, x pass first, each pass rounded to f32,
// taps outside the volume absent (zero padding).
//
// Arithmetic: output o of an axis pass is the fused multiply-add chain
//   acc = 0; for i = max(0, o - r) .. min(n - 1, o + r) ascending:
//     acc = fma(taps[i - o + r], v[i], acc)
// which is what the plain version (sift3d_torch.kernels.gauss.blur3d, a
// banded matmul) computes on the CPU, bit for bit. Skipping the taps that
// fall outside the volume is exact: their products are zeros that leave the
// accumulator unchanged. The library is built with -fmad=false, so every
// fused multiply-add here is the explicit __fmaf_rn.
//
// What bounds it on an H100: device memory. Each voxel is read once and
// written once per blur (the 1 mm T1 octave-0 level is 28.9 MB in and
// 28.9 MB out; the doubled -2+ level 231 MB each way); at most 17 taps per
// axis is about 100 flops per voxel, far below the card's f32 rate.
//
// Design: a block owns a TX x TY column of one volume and a run of TZ output
// planes, and walks the input planes from the run's first output minus r to
// its last plus r. For each input plane it loads the (TY + 2r) x (TX + 2r)
// tile into shared memory, runs the x pass on the TY + 2r rows and the y
// pass on the TX x TY column, and keeps the xy-blurred plane in a ring of
// 2r + 1 planes in shared memory; output plane o is the z chain over that
// ring. So the volume crosses device memory once each way (plus the x/y
// halo and the 2r halo planes of each z run), where the plain version makes
// three passes and two transposed copies. The radius is a template
// parameter (one instance per r in 1..8): the tap loops unroll, the taps
// live in registers and every index is computed with constant divisors.
// Each block walks its planes one after another, so the next plane's tile
// is fetched into registers while the current one is blurred.

#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int TZ = 32;     // output planes per block
constexpr int MAX_R = 8;   // sigma 3.09 (the widest pyramid blur) has r = 8

template <int R>
__global__ void __launch_bounds__(TX * TY)
blur3d_kernel(const float* __restrict__ in, float* __restrict__ out,
              const float* __restrict__ taps_g, int Z, int Y, int X,
              int x_tiles, int z_runs) {
  constexpr int NT = 2 * R + 1;  // taps, and planes in the ring
  constexpr int HW = TX + 2 * R;
  constexpr int HH = TY + 2 * R;
  __shared__ float tile[HH][HW];      // input plane, tile + x/y halo
  __shared__ float xpass[HH][TX];     // x-blurred rows, tile + y halo
  __shared__ float ring[NT][TY][TX];  // xy-blurred planes

  float taps[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) taps[k] = taps_g[k];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  // blockIdx.x enumerates (volume, z run, x tile), x tile fastest
  const int x0 = (int)(blockIdx.x % x_tiles) * TX, y0 = blockIdx.y * TY;
  const int run = (int)(blockIdx.x / x_tiles);
  const int b = run / z_runs;
  const int z0 = (run % z_runs) * TZ;
  const int z1 = min(z0 + TZ, Z);
  const size_t plane = (size_t)Y * X;
  const float* vin = in + (size_t)b * Z * plane;
  float* vout = out + (size_t)b * Z * plane;
  const int x = x0 + tx, y = y0 + ty;
  const bool own = x < X && y < Y;

  // Each chain runs over the taps in ascending input index; taps whose
  // input lies outside the volume are skipped.
  //
  // The block walks its input planes in order. The next plane's tile is
  // fetched into registers while the current one is blurred, so the loads'
  // latency overlaps the x and y passes; output plane o is written as soon
  // as its last input plane, min(Z - 1, o + R), is in the ring.
  constexpr int LOADS = (HH * HW + TX * TY - 1) / (TX * TY);
  float pre[LOADS];
  auto fetch = [&](int p) {
    const float* src = vin + (size_t)p * plane;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int e = tid + l * TX * TY;
      const int gy = y0 - R + e / HW, gx = x0 - R + e % HW;
      pre[l] = (e < HH * HW && gy >= 0 && gy < Y && gx >= 0 && gx < X)
                   ? src[(size_t)gy * X + gx] : 0.0f;
    }
  };
  const int p_first = max(0, z0 - R), p_last = min(Z - 1, z1 - 1 + R);
  int o = z0;  // next output plane
  fetch(p_first);
  for (int p = p_first; p <= p_last; ++p) {
    // 1. the input plane's tile with its x/y halo (zeros outside)
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int e = tid + l * TX * TY;
      if (e < HH * HW) tile[e / HW][e % HW] = pre[l];
    }
    __syncthreads();
    if (p < p_last) fetch(p + 1);
    // 2. x pass on every tile row (y halo rows included)
    for (int e = tid; e < HH * TX; e += TX * TY) {
      const int hy = e / TX, cx = e % TX;
      const int gx = x0 + cx;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const int i = gx - R + k;
        if (i >= 0 && i < X) acc = __fmaf_rn(taps[k], tile[hy][cx + k], acc);
      }
      xpass[hy][cx] = acc;
    }
    __syncthreads();
    // 3. y pass into the ring (each thread reads back only its own column)
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int j = y - R + k;
      if (j >= 0 && j < Y) acc = __fmaf_rn(taps[k], xpass[ty + k][tx], acc);
    }
    ring[p % NT][ty][tx] = acc;
    // 4. z pass: every output plane whose inputs are all in the ring
    for (; o < z1 && min(Z - 1, o + R) <= p; ++o) {
      if (!own) continue;
      float zacc = 0.0f;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const int kz = o - R + k;
        if (kz >= 0 && kz < Z) zacc = __fmaf_rn(taps[k], ring[kz % NT][ty][tx], zacc);
      }
      vout[(size_t)o * plane + (size_t)y * X + x] = zacc;
    }
  }
}

template <int R>
int launch(const float* in, float* out, const float* taps, int B, int Z, int Y, int X,
           int device, void* stream) {
  const int x_tiles = (X + TX - 1) / TX, z_runs = (Z + TZ - 1) / TZ;
  const dim3 block(TX, TY);
  const dim3 grid((unsigned)B * z_runs * x_tiles, (Y + TY - 1) / TY);
  SIFT3D_LAUNCH(device, blur3d_kernel<R>, grid, block, stream, in, out, taps, Z, Y, X,
                x_tiles, z_runs);
}

}  // namespace

// in, out: [B, Z, Y, X] f32 (distinct buffers); taps: 2r + 1 f32 on the
// device, r in [1, 8].
extern "C" int sift3d_blur3d(const float* in, float* out, const float* taps, int r,
                             int B, int Z, int Y, int X, int device, void* stream) {
  switch (r) {
    case 1: return launch<1>(in, out, taps, B, Z, Y, X, device, stream);
    case 2: return launch<2>(in, out, taps, B, Z, Y, X, device, stream);
    case 3: return launch<3>(in, out, taps, B, Z, Y, X, device, stream);
    case 4: return launch<4>(in, out, taps, B, Z, Y, X, device, stream);
    case 5: return launch<5>(in, out, taps, B, Z, Y, X, device, stream);
    case 6: return launch<6>(in, out, taps, B, Z, Y, X, device, stream);
    case 7: return launch<7>(in, out, taps, B, Z, Y, X, device, stream);
    case 8: return launch<MAX_R>(in, out, taps, B, Z, Y, X, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
