// K2: axis-aligned 11^3 patches around refined keypoints.
//
// Replaces the Pallas kernel sift3d/kernels/patch.py:
// sample_patches_identity_slab (_id_slab_kernel). Per row r: the patch at
// centre + k * (2 * scale / 5), k = -5..5 per axis, read from Gaussian level
// lvl[r] with separable 2-tap linear taps (0.5-voxel centres, saturating at
// the volume border: the _interp_coord rule).
//
// What bounds it on an H100: gather latency and bytes. Each output reads 8
// floats at data-dependent addresses; the 11 x 11 x 11 taps of a row share
// 11 indices per axis, so most of the 10,648 reads per row hit L1/L2.
//
// Design: one block per row, reading the full level volume directly (no
// box, no slab: rows are exact and all live). The first 33 threads compute
// the row's per-axis tap indices and weights into shared memory; then each
// thread produces outputs contracting z first, then y, then x — the order of
// the boxed oracle (patch.py:210-212) and of the plain version.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sample_identity_kernel(const float* __restrict__ g, const int* __restrict__ lvl,
                       const float* __restrict__ centers, const float* __restrict__ scales,
                       float* __restrict__ out, int L, int Z, int Y, int X) {
  using namespace sift3d;
  __shared__ int idx[3][kPatchDim];
  __shared__ float wt[3][kPatchDim];
  const int r = blockIdx.x;
  const int l = lvl[r];
  float* o = out + (size_t)r * kPatchVox;
  if (l < 0 || l >= L) {  // whole block takes this branch together
    for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) o[t] = NAN;
    return;
  }
  if (threadIdx.x < 3 * kPatchDim) {
    const int a = threadIdx.x / kPatchDim;  // 0 = x, 1 = y, 2 = z
    const int k = threadIdx.x % kPatchDim;
    const float fac = 2.0f * scales[r] / 5.0f;
    const float u = centers[r * 3 + a] + (float)(k - kPatchRad) * fac;
    const int dim = a == 0 ? X : (a == 1 ? Y : Z);
    interp_coord(u, dim, idx[a][k], wt[a][k]);
  }
  __syncthreads();
  const size_t sz = (size_t)Y * X;
  const float* gl = g + (size_t)l * Z * sz;
  for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) {
    const int kz = t / (kPatchDim * kPatchDim);
    const int ky = (t / kPatchDim) % kPatchDim;
    const int kx = t % kPatchDim;
    const float wz = wt[2][kz], wy = wt[1][ky], wx = wt[0][kx];
    const float* p = gl + (size_t)idx[2][kz] * sz + (size_t)idx[1][ky] * X + idx[0][kx];
    const float a00 = wz * p[0] + (1.0f - wz) * p[sz];
    const float a01 = wz * p[1] + (1.0f - wz) * p[sz + 1];
    const float a10 = wz * p[X] + (1.0f - wz) * p[sz + X];
    const float a11 = wz * p[X + 1] + (1.0f - wz) * p[sz + X + 1];
    const float b0 = wy * a00 + (1.0f - wy) * a10;
    const float b1 = wy * a01 + (1.0f - wy) * a11;
    o[t] = wx * b0 + (1.0f - wx) * b1;
  }
}

}  // namespace

extern "C" int sift3d_sample_identity(const float* g, const int* lvl, const float* centers,
                                      const float* scales, float* out, int R, int L, int Z,
                                      int Y, int X, int device, void* stream) {
  SIFT3D_LAUNCH(device, sample_identity_kernel, dim3(R), dim3(kThreads), stream, g, lvl,
                centers, scales, out, L, Z, Y, X);
}
