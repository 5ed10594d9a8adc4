// Shared device helpers for the sift3d_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sift3d {

constexpr int kPatchDim = 11;                 // patch / histogram edge
constexpr int kPatchRad = kPatchDim / 2;      // 5
constexpr int kPatchVox = kPatchDim * kPatchDim * kPatchDim;  // 1331
constexpr int kRowThreads = 256;              // block size of the one-block-per-row kernels

// Index + weight for 1D linear interpolation at bin coordinate u (bin i's
// centre at u = i), exactly as sift3d_torch.kernels.resample.interp_bin
// computes it:
//   value = w * v[i] + (1 - w) * v[i + 1],  i in [0, dim - 2].
__device__ __forceinline__ void interp_bin(float u, int dim, int& i, float& w) {
  // clamp in float before converting so far-away coordinates cannot overflow
  const float f = fminf(fmaxf(floorf(u), 0.0f), (float)(dim - 2));
  i = (int)f;
  w = 1.0f - (u - (float)i);
  if (u < 0.0f) w = 1.0f;
  if (u >= (float)(dim - 1)) w = 0.0f;
}

// The same at voxel coordinate c with the 0.5-voxel-centre convention
// (_fioDetermineInterpCoord, FeatureIO.cpp:752-781), as
// sift3d_torch.kernels.resample.interp_coord.
__device__ __forceinline__ void interp_coord(float c, int dim, int& i, float& w) {
  interp_bin(c - 0.5f, dim, i, w);
}

// ---- the quadratic refinement (K2, the fused canonical kernels) ----

// kernels/extrema.py _det3: det [[p1 p2 p3], [q1 q2 q3], [1 1 1]]. An
// explicit fmaf fuses under -fmad=false and rounds once, as
// numerics.fma_exact does.
__device__ __forceinline__ float det3(float p1, float p2, float p3, float q1, float q2, float q3) {
  float t = fmaf(p1, q2, -(p1 * q3));
  t = fmaf(-p2, q1, t);
  t = fmaf(p3, q1, t);
  t = fmaf(p2, q3, t);
  return fmaf(-p3, q2, t);
}

// kernels/extrema.py quadratic_interp_1d.
__device__ __forceinline__ float quadratic_interp(float flo, float fc, float fhi, float xlo, float xc,
                                                  float xhi) {
  const float a1 = xlo * xlo, a2 = xc * xc, a3 = xhi * xhi;
  const float det = det3(a1, a2, a3, xlo, xc, xhi);
  const float detx = det3(flo, fc, fhi, xlo, xc, xhi);
  const float dety = det3(a1, a2, a3, flo, fc, fhi);
  const bool valid = det != 0.0f && detx != 0.0f;
  const float denom = valid ? -2.0f * detx : 1.0f;
  return valid ? dety / denom : xc;
}

// ---- the 11^3 samplers (K2, K4), patch_cuda's plain versions' order ----

// The trilinear value at corner p (lower corner of the 2x2x2 cell, plane
// stride sz, row stride X), contracting z first, then y, then x; the
// weights apply to the lower corner.
__device__ __forceinline__ float trilinear_zyx(const float* p, size_t sz, int X, float wz, float wy,
                                               float wx) {
  const float a00 = wz * p[0] + (1.0f - wz) * p[sz];
  const float a01 = wz * p[1] + (1.0f - wz) * p[sz + 1];
  const float a10 = wz * p[X] + (1.0f - wz) * p[sz + X];
  const float a11 = wz * p[X + 1] + (1.0f - wz) * p[sz + X + 1];
  const float b0 = wy * a00 + (1.0f - wy) * a10;
  const float b1 = wy * a01 + (1.0f - wy) * a11;
  return wx * b0 + (1.0f - wx) * b1;
}

// Tap k (0..10) of an identity patch along axis a (0 = x, 1 = y, 2 = z)
// around centre c with scale s: the plane or column index (z moved into a
// slab from global plane z0 and clamped to its Z planes) and the weight.
__device__ __forceinline__ void identity_tap(float c, float s, int a, int k, int X, int Y, int Z,
                                             int z0, int depth, int& i, float& w) {
  const float fac = 2.0f * s / 5.0f;
  const float u = c + (float)(k - kPatchRad) * fac;
  interp_coord(u, a == 0 ? X : (a == 1 ? Y : depth), i, w);
  if (a == 2) i = min(max(i - z0, 0), Z - 2);
}

// invert_3x3 (MultiScale.h:192-222), the JAX package's operation order.
__device__ __forceinline__ void invert_3x3(const float* m, float* inv) {
  const float a11 = m[0], a12 = m[1], a13 = m[2];
  const float a21 = m[3], a22 = m[4], a23 = m[5];
  const float a31 = m[6], a32 = m[7], a33 = m[8];
  const float det = a11 * (a33 * a22 - a32 * a23) - a21 * (a33 * a12 - a32 * a13) +
                    a31 * (a23 * a12 - a22 * a13);
  const float inv_det = 1.0f / det;
  inv[0] = (a33 * a22 - a32 * a23) * inv_det;
  inv[1] = -(a33 * a12 - a32 * a13) * inv_det;
  inv[2] = (a23 * a12 - a22 * a13) * inv_det;
  inv[3] = -(a33 * a21 - a31 * a23) * inv_det;
  inv[4] = (a33 * a11 - a31 * a13) * inv_det;
  inv[5] = -(a23 * a11 - a21 * a13) * inv_det;
  inv[6] = (a32 * a21 - a31 * a22) * inv_det;
  inv[7] = -(a32 * a11 - a31 * a12) * inv_det;
  inv[8] = (a22 * a11 - a21 * a12) * inv_det;
}

// Point t (z-major) of a rotated patch: centre + inv * k * fac, trilinear
// from level gl of a slab (z0, depth as identity_tap), 0 where x leaves
// [0, X) (reference quirk 4).
__device__ __forceinline__ float rotated_point(const float* gl, const float* inv, float fac, float cx,
                                               float cy, float cz, int t, int Z, int Y, int X, int z0,
                                               int depth) {
  const float gz = (float)(t / (kPatchDim * kPatchDim) - kPatchRad);
  const float gy = (float)((t / kPatchDim) % kPatchDim - kPatchRad);
  const float gx = (float)(t % kPatchDim - kPatchRad);
  const float x = (inv[0] * gx + inv[1] * gy + inv[2] * gz) * fac + cx;
  const float y = (inv[3] * gx + inv[4] * gy + inv[5] * gz) * fac + cy;
  const float z = (inv[6] * gx + inv[7] * gy + inv[8] * gz) * fac + cz;
  int ix, iy, iz;
  float wx, wy, wz;
  interp_coord(x, X, ix, wx);
  interp_coord(y, Y, iy, wy);
  interp_coord(z, depth, iz, wz);
  iz = min(max(iz - z0, 0), Z - 2);
  const size_t sz = (size_t)Y * X;
  const float v = trilinear_zyx(gl + (size_t)iz * sz + (size_t)iy * X + ix, sz, X, wz, wy, wx);
  return (x < 0.0f || x >= (float)X) ? 0.0f : v;
}

// ---- fixed-order sums: sift3d_torch.core.numerics.tree_sum ----
//
// tree_sum zero-pads the axis to the next power of two n and halves it until
// one element is left, each step adding element i + n/2 to element i. The
// helpers below compute exactly that pairing, so a row's sums do not depend
// on the device, the batch or the launch.

// K sums over i in [0, n), n <= 2048 (padded to 2048). term(i, v) writes the
// K terms of element i and is called only for i < n. Every thread of a
// kRowThreads block calls this; K <= 8; red holds K * kRowThreads floats of
// shared scratch. Every thread gets the K sums.
template <int K, class Term>
__device__ __forceinline__ void tree_sum_2048(int n, Term term, float* red, float (&sum)[K]) {
  static_assert(K <= kRowThreads / 32, "one warp per sum");
  const int t = threadIdx.x;
  float a[4][K];  // step 1024: elements t + 256 k, k = 0..3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = t + kRowThreads * k;
    float lo[K], hi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) lo[j] = hi[j] = 0.0f;
    if (i < n) term(i, lo);
    if (i + 1024 < n) term(i + 1024, hi);
#pragma unroll
    for (int j = 0; j < K; ++j) a[k][j] = lo[j] + hi[j];
  }
  // steps 512 and 256 stay in the thread: (t + t+512) + (t+256 + t+768)
#pragma unroll
  for (int j = 0; j < K; ++j) red[j * kRowThreads + t] = (a[0][j] + a[2][j]) + (a[1][j] + a[3][j]);
  __syncthreads();
  const int w = t >> 5, l = t & 31;
  if (w < K) {
    const float* s = red + w * kRowThreads;
    // steps 128, 64 and 32 for element l
    float v = ((s[l] + s[l + 128]) + (s[l + 64] + s[l + 192])) +
              ((s[l + 32] + s[l + 160]) + (s[l + 96] + s[l + 224]));
    // steps 16 .. 1: lane l adds lane l + h (lane 0 ends with the sum)
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, h);
    if (l == 0) red[w * kRowThreads] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) sum[j] = red[j * kRowThreads];
  __syncthreads();  // red may be reused at once
}

// tree_sum of 64 values over one warp: lane l passes elements l and l + 32.
// Every lane gets the sum.
__device__ __forceinline__ float warp_tree_sum_64(float lo, float hi) {
  float v = lo + hi;
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, h);
  return __shfl_sync(0xffffffffu, v, 0);
}

// ---- patch helpers of sift3d_torch.kernels.patch ----

// normalize_patches on one 11^3 patch in shared memory, in place: subtract
// the mean, divide by the L2 norm where it is > 0. Every thread calls it.
__device__ __forceinline__ void normalize_patch(float* p, float* red) {
  float s[1];
  tree_sum_2048<1>(kPatchVox, [&](int i, float (&v)[1]) { v[0] = p[i]; }, red, s);
  const float mean = s[0] / (float)kPatchVox;
  for (int i = threadIdx.x; i < kPatchVox; i += kRowThreads) p[i] = p[i] - mean;
  __syncthreads();
  tree_sum_2048<1>(kPatchVox, [&](int i, float (&v)[1]) { v[0] = p[i] * p[i]; }, red, s);
  const float norm = sqrtf(s[0]);
  const float d = norm > 0.0f ? norm : 1.0f;
  for (int i = threadIdx.x; i < kPatchVox; i += kRowThreads) p[i] = p[i] / d;
  __syncthreads();
}

// patch_gradients at voxel i (z-major) of an 11^3 patch: central
// differences inside, 0 on the patch's border.
__device__ __forceinline__ void patch_gradient(const float* p, int i, float& gx, float& gy, float& gz) {
  const int z = i / (kPatchDim * kPatchDim), y = (i / kPatchDim) % kPatchDim, x = i % kPatchDim;
  gx = gy = gz = 0.0f;
  if (z > 0 && z < kPatchDim - 1 && y > 0 && y < kPatchDim - 1 && x > 0 && x < kPatchDim - 1) {
    gx = p[i + 1] - p[i - 1];
    gy = p[i + kPatchDim] - p[i - kPatchDim];
    gz = p[i + kPatchDim * kPatchDim] - p[i - kPatchDim * kPatchDim];
  }
}

// sphere_mask: voxel i lies strictly inside the radius-5 sphere.
__device__ __forceinline__ bool in_sphere(int i) {
  const int z = i / (kPatchDim * kPatchDim) - kPatchRad;
  const int y = (i / kPatchDim) % kPatchDim - kPatchRad;
  const int x = i % kPatchDim - kPatchRad;
  return z * z + y * y + x * x < kPatchRad * kPatchRad;
}

constexpr int sphere_count() {
  int n = 0;
  for (int z = -kPatchRad; z <= kPatchRad; ++z)
    for (int y = -kPatchRad; y <= kPatchRad; ++y)
      for (int x = -kPatchRad; x <= kPatchRad; ++x) n += z * z + y * y + x * x < kPatchRad * kPatchRad;
  return n;
}
constexpr int kSphereV = sphere_count();  // 485 in-sphere voxels
static_assert(kSphereV == 485, "the in-sphere voxels of an 11^3 patch");

// ---- the 11^3 blur (K7's small-volume kernel, the fused BRIEF kernel) ----

constexpr int kBlurMaxR = 8;  // sigma 3.09 (the widest pyramid blur) has r = 8

// The taps of a zero-border blur of radius r <= kBlurMaxR, passed by value
// (a kernel parameter: the constant bank).
struct BlurTaps {
  float t[2 * kBlurMaxR + 1];
};

// Output o of one axis pass of a zero-border blur of radius R over n inputs
// v(i): the fused multiply-add chain from 0 over the taps whose input lies in
// [0, n), in ascending input index (gauss.blur3d's chain; v is called only
// for i in range).
template <int R, class V>
__device__ __forceinline__ float blur_chain(const BlurTaps& taps, int o, int n, V v) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * R + 1; ++k) {
    const int i = o - R + k;
    if (i >= 0 && i < n) acc = __fmaf_rn(taps.t[k], v(i), acc);
  }
  return acc;
}

// torch.maximum / amax and torch.minimum / amin: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

// ---- the matching kernels' distances (M1, M2): knn_cuda.dist_sqr_plain ----

// Squared norm of a C-vector, x(c) its element c, in the order XLA's CPU
// code sums the JAX kNN's (q * q).sum(-1): the squares rounded, the columns
// cut into windows of 32 (C > 32: padded evenly on both sides), each window
// summed from 0 in column order, and the window sums added from 0.
template <int C, class X>
__device__ __forceinline__ float window_sq_norm(X x) {
  constexpr int kNW = C <= 32 ? 1 : (C + 31) / 32;
  constexpr int kLeft = C <= 32 ? 0 : (kNW * 32 - C) / 2;
  float tot = 0.0f;
#pragma unroll
  for (int w = 0; w < kNW; ++w) {
    const int lo = max(0, 32 * w - kLeft), hi = C <= 32 ? C : min(C, 32 * w + 32 - kLeft);
    float acc = 0.0f;
#pragma unroll
    for (int c = lo; c < hi; ++c) {
      const float v = x(c);
      const float sq = v * v;
      acc = acc + sq;
    }
    tot = tot + acc;
  }
  return tot;
}

// ---- the matching kernels' int8 route (M1, M2) ----

// Four values of an int8-range integer row, packed little-endian.
__device__ __forceinline__ int pack4(const float* v) {
  unsigned w = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) w |= ((unsigned)__float2int_rn(v[u]) & 0xffu) << (8 * u);
  return (int)w;
}

// c += a b on the int8 tensor cores: m16n8k32, s8 inputs, s32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of m16n8k32 for the 16 query rows q0 .. q0 + 15 of a warp
// (rows >= Q read as zeros), with the k order permuted: step s, register
// 2h + r holds bytes 16t + 8s + 4h .. + 3 of row g + 8r (g, t: the lane's
// group and thread in group); a B fragment holds the same bytes of its
// column, so one 16-byte load of a 64-byte row gives both steps.
__device__ __forceinline__ void query_fragments(const float* q, int C, int q0, int Q, int (&a)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    const bool live = row < Q;
    const float* qr = q + (size_t)(live ? row : 0) * C;
    int w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = live ? pack4(qr + 16 * t + 4 * u) : 0;
    a[0][r] = w[0];
    a[0][2 + r] = w[1];
    a[1][r] = w[2];
    a[1][2 + r] = w[3];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Select the device, then launch on `stream`; returns cudaGetLastError().
#define SIFT3D_LAUNCH(device, kernel, grid, block, stream, ...)          \
  do {                                                                   \
    cudaError_t set_err = cudaSetDevice(device);                         \
    if (set_err != cudaSuccess) return (int)set_err;                     \
    kernel<<<grid, block, 0, (cudaStream_t)(stream)>>>(__VA_ARGS__);     \
    return (int)cudaGetLastError();                                      \
  } while (0)

}  // namespace sift3d
