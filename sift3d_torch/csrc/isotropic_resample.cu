// Trilinear resampling of a batch of anisotropic volumes to the isotropic
// grid of their smallest voxel size: featExtract's -w / -ws
// (featExtract.cpp:118-204, fioGetPixelTrilinearInterp,
// FeatureIO.cpp:813-852).
//
// Replaces no TPU kernel: the JAX package resamples eagerly, one XLA op at
// a time (sift3d/kernels/resample.py: isotropic_resample), and so does the
// port's plain chain (sift3d_torch/kernels/resample.py: isotropic_resample),
// meshgrids of the sample centres, int64 index grids, eight gathers and
// seven lerps, whose temporaries reach about 4.9 GB for one 128x256x256
// volume. This kernel takes its place on the card, in one pass over a
// contiguous f32 [B, Z, Y, X] batch into a contiguous f32 [B, OZ, OY, OX]
// output, with the chain's arithmetic, bit for bit: output o of an axis
// samples at c = o * f + 0.5 (f = dmin / d rounded to f32; the product and
// the sum each rounded, __fmul_rn, __fadd_rn), interp_coord's index and
// weight (common.cuh), then trilinear_sample's six lerps in its order: x on
// the four rows, then y, then z (built with -fmad=false: never contracted).
// An axis of one voxel gets the index -1 from interp_coord's clamp to
// [0, dim - 2]; the chain's indexing wraps it to the voxel itself, and so
// does this kernel. No index or coordinate grid is materialised: each
// thread computes its three axes' indices and weights.
//
// What bounds it on an H100: device memory. It reads 4 bytes a voxel of the
// input and writes 4 a voxel of the output (an OASIS-1 MP-RAGE scan,
// 128x256x256 -> 160x256x256: 33.5 MB in, 41.9 MB out, 22.5 us at
// 3.35 TB/s). Design: a thread writes one output voxel, neighbouring threads
// on neighbouring x, so the stores coalesce and the eight reads of
// neighbouring threads fall on the same lines of two input rows in each of
// two input planes, served from L1/L2. Blocks walk (y, x) fastest, then the
// output plane oz, then the volume.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// output index o of an axis of n inputs at the f32 factor f: the lower and
// upper input index and the lower one's weight
__device__ __forceinline__ void axis_tap(int o, float f, int n, int& i0, int& i1, float& w) {
  const float c = __fadd_rn(__fmul_rn((float)o, f), 0.5f);
  int i;
  sift3d::interp_coord(c, n, i, w);
  i0 = i < 0 ? i + n : i;  // -1 only on an axis of one voxel: the voxel itself
  i1 = i + 1;
}

__device__ __forceinline__ float lerp(float w, float a, float b) {
  return __fadd_rn(__fmul_rn(w, a), __fmul_rn(__fsub_rn(1.0f, w), b));
}

__global__ void __launch_bounds__(THREADS)
isotropic_resample_kernel(const float* __restrict__ in, float* __restrict__ out, int Z, int Y, int X, int OY,
                          int OX, float fz, float fy, float fx) {
  const long long plane = (long long)OY * OX;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= plane) return;
  const int oy = (int)(idx / OX), ox = (int)(idx - (long long)oy * OX);
  const int oz = blockIdx.y, b = blockIdx.z;
  int z0, z1, y0, y1, x0, x1;
  float wz, wy, wx;
  axis_tap(oz, fz, Z, z0, z1, wz);
  axis_tap(oy, fy, Y, y0, y1, wy);
  axis_tap(ox, fx, X, x0, x1, wx);
  const size_t ps = (size_t)Y * X;
  const float* v = in + (size_t)b * Z * ps;
  auto g = [&](int z, int y, int x) { return __ldg(v + (size_t)z * ps + (size_t)y * X + x); };
  const float n00 = lerp(wx, g(z0, y0, x0), g(z0, y0, x1));
  const float n01 = lerp(wx, g(z1, y0, x0), g(z1, y0, x1));
  const float n10 = lerp(wx, g(z0, y1, x0), g(z0, y1, x1));
  const float n11 = lerp(wx, g(z1, y1, x0), g(z1, y1, x1));
  const float nn0 = lerp(wy, n00, n10);
  const float nn1 = lerp(wy, n01, n11);
  out[((size_t)b * gridDim.y + oz) * plane + idx] = lerp(wz, nn0, nn1);
}

}  // namespace

// in [B, Z, Y, X] f32, out [B, OZ, OY, OX] f32, both contiguous on the
// device; fz, fy, fx: each axis's dmin / d as f32; B, OZ <= 65535 (the
// grid's z and y).
extern "C" int sift3d_isotropic_resample(const float* in, float* out, int B, int Z, int Y, int X, int OZ, int OY,
                                         int OX, float fz, float fy, float fx, int device, void* stream) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || OZ < 1 || OY < 1 || OX < 1 || B > 65535 || OZ > 65535)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)OY * OX;
  const dim3 grid((unsigned)((plane + THREADS - 1) / THREADS), OZ, B);
  SIFT3D_LAUNCH(device, isotropic_resample_kernel, grid, dim3(THREADS), stream, in, out, Z, Y, X, OY, OX, fz, fy,
                fx);
}
