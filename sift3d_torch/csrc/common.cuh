// Shared device helpers for the sift3d_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sift3d {

constexpr int kPatchDim = 11;                 // patch / histogram edge
constexpr int kPatchRad = kPatchDim / 2;      // 5
constexpr int kPatchVox = kPatchDim * kPatchDim * kPatchDim;  // 1331

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

// Select the device, then launch on `stream`; returns cudaGetLastError().
#define SIFT3D_LAUNCH(device, kernel, grid, block, stream, ...)          \
  do {                                                                   \
    cudaError_t set_err = cudaSetDevice(device);                         \
    if (set_err != cudaSuccess) return (int)set_err;                     \
    kernel<<<grid, block, 0, (cudaStream_t)(stream)>>>(__VA_ARGS__);     \
    return (int)cudaGetLastError();                                      \
  } while (0)

}  // namespace sift3d
