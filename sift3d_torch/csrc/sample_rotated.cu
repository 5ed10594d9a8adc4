// K4 (with K5): rotated 11^3 patches for the reoriented feature copies.
//
// Replaces the Pallas kernels sift3d/kernels/patch.py:
// sample_patches_rotated_slab (_rot_slab_kernel, 24^3 / 48^3 boxes) and
// sample_patches_rotated_pallas (_rot_kernel, the 64^3 box for the
// large-scale tail). Per row r: grid point k in [-5, 5]^3 maps to
// centre + ori^-1 k * (2 * scale / 5); the value is trilinear from Gaussian
// level lvl[r] with the _interp_coord saturation, and points with x outside
// [0, X) read 0 (reference quirk 4, patch.py:12-18). These are the boxless
// semantics of sample_patches_leveled: no scale bound, unlike a box. The
// volume may be a Z slab of a deeper one (the Z-sharded path): z0 is the
// global index of its first plane and depth the global Z; coordinates clamp
// and interpolate in global terms and only the integer plane index moves
// into the slab (clamped to it, so no read leaves the tensor).
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

// The GoH path runs the fused K4 (csrc/rotated_goh.cu), which samples with the
// same helpers; this patch mode serves the BRIEF descriptors (-b/-br/-bn).

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(sift3d::kRowThreads)
sample_rotated_kernel(const float* __restrict__ g, const int* __restrict__ lvl,
                      const float* __restrict__ centers, const float* __restrict__ scales,
                      const float* __restrict__ oris, float* __restrict__ out, int L, int Z,
                      int Y, int X, int z0, int depth) {
  using namespace sift3d;
  __shared__ float inv[9];
  const int r = blockIdx.x;
  const int l = lvl[r];
  float* o = out + (size_t)r * kPatchVox;
  if (l < 0 || l >= L) {  // whole block takes this branch together
    for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) o[t] = NAN;
    return;
  }
  if (threadIdx.x == 0) invert_3x3(oris + (size_t)r * 9, inv);
  __syncthreads();
  const float fac = 2.0f * scales[r] / 5.0f;
  const float cx = centers[r * 3 + 0], cy = centers[r * 3 + 1], cz = centers[r * 3 + 2];
  const float* gl = g + (size_t)l * Z * Y * X;
  for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x)
    o[t] = rotated_point(gl, inv, fac, cx, cy, cz, t, Z, Y, X, z0, depth);
}

}  // namespace

extern "C" int sift3d_sample_rotated(const float* g, const int* lvl, const float* centers,
                                     const float* scales, const float* oris, float* out, int R,
                                     int L, int Z, int Y, int X, int z0, int depth, int device,
                                     void* stream) {
  SIFT3D_LAUNCH(device, sample_rotated_kernel, dim3(R), dim3(sift3d::kRowThreads), stream, g, lvl,
                centers, scales, oris, out, L, Z, Y, X, z0, depth);
}
