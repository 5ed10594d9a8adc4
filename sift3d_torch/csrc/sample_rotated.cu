// K4 (with K5): rotated 11^3 patches for the reoriented feature copies.
//
// Replaces the Pallas kernels sift3d/kernels/patch.py:
// sample_patches_rotated_slab (_rot_slab_kernel, 24^3 / 48^3 boxes) and
// sample_patches_rotated_pallas (_rot_kernel, the 64^3 box for the
// large-scale tail). Per row r: grid point k in [-5, 5]^3 maps to
// centre + ori^-1 k * (2 * scale / 5); the value is trilinear from Gaussian
// level lvl[r] with the _interp_coord saturation, and points with x outside
// [0, X) read 0 (reference quirk 4, patch.py:12-18). These are the boxless
// semantics of sample_patches_leveled: no scale bound, unlike a box.
//
// What bounds it on an H100: gather latency. 8 reads per output at
// rotated, data-dependent addresses; a row's 1331 points span at most a
// (4 * sqrt(3) * scale)^3 region, so reads mostly hit L1/L2.
//
// Design: one block per row reading the full level volume — no boxes, so
// the TPU's three box sizes collapse into one kernel. Thread 0 inverts the
// orientation (the analytic invert_3x3, same operation order as the plain
// version); each thread then maps its points and contracts the 8 corners
// z first, then y, then x (the boxed oracle's order).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sample_rotated_kernel(const float* __restrict__ g, const int* __restrict__ lvl,
                      const float* __restrict__ centers, const float* __restrict__ scales,
                      const float* __restrict__ oris, float* __restrict__ out, int L, int Z,
                      int Y, int X) {
  using namespace sift3d;
  __shared__ float inv[9];
  const int r = blockIdx.x;
  const int l = lvl[r];
  float* o = out + (size_t)r * kPatchVox;
  if (l < 0 || l >= L) {  // whole block takes this branch together
    for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) o[t] = NAN;
    return;
  }
  if (threadIdx.x == 0) {
    // invert_3x3 (MultiScale.h:192-222), the JAX package's operation order
    const float* m = oris + (size_t)r * 9;
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
  __syncthreads();
  const float fac = 2.0f * scales[r] / 5.0f;
  const float cx = centers[r * 3 + 0], cy = centers[r * 3 + 1], cz = centers[r * 3 + 2];
  const size_t sz = (size_t)Y * X;
  const float* gl = g + (size_t)l * Z * sz;
  for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) {
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
    interp_coord(z, Z, iz, wz);
    const float* p = gl + (size_t)iz * sz + (size_t)iy * X + ix;
    const float a00 = wz * p[0] + (1.0f - wz) * p[sz];
    const float a01 = wz * p[1] + (1.0f - wz) * p[sz + 1];
    const float a10 = wz * p[X] + (1.0f - wz) * p[sz + X];
    const float a11 = wz * p[X + 1] + (1.0f - wz) * p[sz + X + 1];
    const float b0 = wy * a00 + (1.0f - wy) * a10;
    const float b1 = wy * a01 + (1.0f - wy) * a11;
    const float v = wx * b0 + (1.0f - wx) * b1;
    o[t] = (x < 0.0f || x >= (float)X) ? 0.0f : v;
  }
}

}  // namespace

extern "C" int sift3d_sample_rotated(const float* g, const int* lvl, const float* centers,
                                     const float* scales, const float* oris, float* out, int R,
                                     int L, int Z, int Y, int X, int device, void* stream) {
  SIFT3D_LAUNCH(device, sample_rotated_kernel, dim3(R), dim3(kThreads), stream, g, lvl,
                centers, scales, oris, out, L, Z, Y, X);
}
