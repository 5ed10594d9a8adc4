// Fused K4 on the BRIEF path: a rotated 11^3 patch and its BRIEF, RRIEF or
// NRRIEF rank descriptor, one block per row; and the same descriptor of an
// already-sampled patch.
//
// Replaces the Pallas kernels sift3d/kernels/patch.py:
// sample_patches_rotated_slab (_rot_slab_kernel) and, for the large-scale
// tail, sample_patches_rotated_pallas (_rot_kernel), together with the eager
// descriptor code after them in the port (patch_cuda.brief_plain:
// normalize_patches, descriptor.brief_descriptor with K7's pre-blur, the
// pair gathers and the variant, rank_normalize). Per row:
//   1. the rotated patch into shared memory (csrc/sample_rotated.cu's
//      arithmetic, x outside [0, X) reading 0; NaN for a level out of
//      range), or the given patch;
//   2. normalize_patches, both sums in numerics.tree_sum's order;
//   3. the zero-border blur of radius R with the host's taps, K7's
//      small-volume arithmetic (common.cuh's blur_chain): the x pass, the y
//      pass, then the z pass at the 128 pair endpoints only;
//   4. d = I(p) - I(q) for the 64 pairs of the method's table (flat voxel
//      indices, one table a device: descriptor.brief_pairs);
//   5. the variant: d < 0 (BRIEF), d (RRIEF), or d / max(int(|p - q|), 1)
//      (NRRIEF), an IEEE division by the same f32 divisor;
//   6. the rank #{j: v_j < v_i} + #{j < i: v_j == v_i} in the order of a
//      stable sort that puts NaN last (torch.argsort's), on integer keys
//      of that order, so BRIEF's 0/1 values and a NaN row rank as
//      rank_normalize ranks them;
//   7. uint8 [64] out. The patch never reaches device memory.
// -fmad=false keeps every multiply and add separately rounded and the blur's
// fmas are explicit, so each row equals patch_cuda.rotated_brief_plain's (or
// brief_plain's) bit for bit.
//
// What bounds it on an H100: the per-row chain of block-wide steps (the
// sampler, two barriers for each normalization sum, three for the blur) at
// one row per block; device bytes are the touched voxels and 64 B a row out.

#include "common.cuh"

#include <limits.h>

namespace {

using namespace sift3d;

constexpr int kPairs = 64;

// An int that orders as torch's sort orders floats: by value, -0 equal to
// +0, NaN after every number and all NaNs equal.
__device__ __forceinline__ int sort_key(float v) {
  if (v != v) return INT_MAX;
  const int b = __float_as_int(v == 0.0f ? 0.0f : v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

template <int R, bool kSample>
__global__ void __launch_bounds__(sift3d::kRowThreads)
brief_kernel(const float* __restrict__ g, const int* __restrict__ lvl, const float* __restrict__ centers,
             const float* __restrict__ scales, const float* __restrict__ oris, const float* __restrict__ patches,
             const int* __restrict__ pairs, const float* __restrict__ divisor, BlurTaps taps, int variant,
             uint8_t* __restrict__ out, int L, int Z, int Y, int X, int z0, int depth) {
  constexpr int kD = kPatchDim;
  __shared__ float p[kPatchVox];
  __shared__ float b[kPatchVox];
  __shared__ float ends[2 * kPairs];  // the blurred patch at each pair's p, then at its q
  __shared__ int vals[kPairs];         // the variant's values as sort keys
  __shared__ float red[kRowThreads];
  __shared__ float inv[9];
  const int r = blockIdx.x;
  if (kSample) {
    const int l = lvl[r];
    if (l < 0 || l >= L) {  // as K4: the patch is NaN (the tables never give such a row)
      for (int i = threadIdx.x; i < kPatchVox; i += blockDim.x) p[i] = NAN;
    } else {
      if (threadIdx.x == 0) invert_3x3(oris + (size_t)r * 9, inv);
      __syncthreads();
      const float fac = 2.0f * scales[r] / 5.0f;
      const float cx = centers[r * 3 + 0], cy = centers[r * 3 + 1], cz = centers[r * 3 + 2];
      const float* gl = g + (size_t)l * Z * Y * X;
      for (int i = threadIdx.x; i < kPatchVox; i += blockDim.x)
        p[i] = rotated_point(gl, inv, fac, cx, cy, cz, i, Z, Y, X, z0, depth);
    }
  } else {
    for (int i = threadIdx.x; i < kPatchVox; i += blockDim.x) p[i] = patches[(size_t)r * kPatchVox + i];
  }
  __syncthreads();
  normalize_patch(p, red);
  // x pass into b, y pass back into p
  for (int i = threadIdx.x; i < kPatchVox; i += blockDim.x) {
    const int zy = i / kD, x = i % kD;
    b[i] = blur_chain<R>(taps, x, kD, [&](int k) { return p[zy * kD + k]; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPatchVox; i += blockDim.x) {
    const int z = i / (kD * kD), y = (i / kD) % kD, x = i % kD;
    p[i] = blur_chain<R>(taps, y, kD, [&](int k) { return b[(z * kD + k) * kD + x]; });
  }
  __syncthreads();
  // the z pass at the endpoints
  if (threadIdx.x < 2 * kPairs) {
    const int i = pairs[threadIdx.x];
    const int z = i / (kD * kD), yx = i % (kD * kD);
    ends[threadIdx.x] = blur_chain<R>(taps, z, kD, [&](int k) { return p[k * kD * kD + yx]; });
  }
  __syncthreads();
  if (threadIdx.x < kPairs) {
    const int e = threadIdx.x;
    const float d = ends[e] - ends[kPairs + e];
    vals[e] = sort_key(variant == 0 ? (d < 0.0f ? 1.0f : 0.0f) : variant == 1 ? d : d / divisor[e]);
  }
  __syncthreads();
  if (threadIdx.x < kPairs) {
    const int i = threadIdx.x;
    const int v = vals[i];
    int k = 0;
    for (int j = 0; j < kPairs; ++j) {
      const int w = vals[j];
      k += w < v || (j < i && w == v);
    }
    out[(size_t)r * kPairs + i] = (uint8_t)k;
  }
}

template <bool kSample>
int launch(int radius, const float* g, const int* lvl, const float* centers, const float* scales,
           const float* oris, const float* patches, const int* pairs, const float* divisor,
           const BlurTaps& taps, int variant, uint8_t* out, int R, int L, int Z, int Y, int X, int z0,
           int depth, int device, void* stream) {
  void (*kernel)(const float*, const int*, const float*, const float*, const float*, const float*,
                 const int*, const float*, BlurTaps, int, uint8_t*, int, int, int, int, int, int) =
      radius == 1   ? brief_kernel<1, kSample>
      : radius == 2 ? brief_kernel<2, kSample>
      : radius == 3 ? brief_kernel<3, kSample>
      : radius == 4 ? brief_kernel<4, kSample>
      : radius == 5 ? brief_kernel<5, kSample>
      : radius == 6 ? brief_kernel<6, kSample>
      : radius == 7 ? brief_kernel<7, kSample>
      : radius == 8 ? brief_kernel<8, kSample>
                    : nullptr;
  if (kernel == nullptr || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  SIFT3D_LAUNCH(device, kernel, dim3(R), dim3(sift3d::kRowThreads), stream, g, lvl, centers, scales, oris,
                patches, pairs, divisor, taps, variant, out, L, Z, Y, X, z0, depth);
}

BlurTaps host_taps(const float* taps, int radius) {
  BlurTaps t = {};
  for (int k = 0; k < 2 * radius + 1; ++k) t.t[k] = taps[k];
  return t;
}

}  // namespace

// gstack [L, Z, Y, X] (a slab from global plane z0 of a volume depth deep),
// lvl [R] int32, centers [R, 3], scales [R], oris [R, 3, 3]; pairs [2, 64]
// int32 flat voxel indices (z * 121 + y * 11 + x) of the pairs' p and q,
// divisor [64] f32 (NRRIEF's); taps [2 radius + 1] f32 in host memory,
// radius 1..8 (K7's); variant 0 BRIEF, 1 RRIEF, 2 NRRIEF; out [R, 64] uint8.
extern "C" int sift3d_rotated_brief(const float* g, const int* lvl, const float* centers, const float* scales,
                                    const float* oris, const int* pairs, const float* divisor,
                                    const float* taps, int radius, int variant, uint8_t* out, int R, int L,
                                    int Z, int Y, int X, int z0, int depth, int device, void* stream) {
  if (radius < 1 || radius > sift3d::kBlurMaxR) return (int)cudaErrorInvalidValue;
  return launch<true>(radius, g, lvl, centers, scales, oris, nullptr, pairs, divisor, host_taps(taps, radius),
                      variant, out, R, L, Z, Y, X, z0, depth, device, stream);
}

// The same descriptor of given patches [R, 11, 11, 11] f32.
extern "C" int sift3d_brief(const float* patches, const int* pairs, const float* divisor, const float* taps,
                            int radius, int variant, uint8_t* out, int R, int device, void* stream) {
  if (radius < 1 || radius > sift3d::kBlurMaxR) return (int)cudaErrorInvalidValue;
  return launch<false>(radius, nullptr, nullptr, nullptr, nullptr, nullptr, patches, pairs, divisor,
                       host_taps(taps, radius), variant, out, R, 0, 0, 0, 0, 0, 0, device, stream);
}
