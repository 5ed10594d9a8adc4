// Fused K4: rotated 11^3 patch and its GoH-64 rank descriptor, one block per
// row; and the same descriptor of an already-sampled patch.
//
// Replaces the Pallas kernels sift3d/kernels/patch.py:
// sample_patches_rotated_slab (_rot_slab_kernel) and, for the large-scale
// tail, sample_patches_rotated_pallas (_rot_kernel), together with the eager
// descriptor code after them in the port (sift3d_torch.kernels.descriptor:
// normalize_patches, goh_descriptor, normalize_positive, rank_normalize).
// Per row:
//   1. the rotated patch into shared memory (csrc/sample_rotated.cu's
//      arithmetic, x outside [0, X) reading 0), or the given patch;
//   2. normalize_patches, both sums in numerics.tree_sum's order;
//   3. gradients and magnitude (sqrtf, correctly rounded as numerics.sqrt);
//   4. the orientation bin: the first maximum of the 8 cube-corner dots;
//   5. the 2x2x2x8 splat with spatial_weight_table, contracted x, then y,
//      then z, each an ascending chain from 0 of separately rounded
//      multiply-adds (goh_descriptor's order);
//   6. normalize_positive: the min, the tree_sum of 64 squares, sqrtf, the
//      division;
//   7. the rank #{j: v_j < v_i} + #{j < i: v_j == v_i}, a stable argsort's
//      place (ties are common: a shifted row has a 0, a flat patch 64);
//   8. uint8 [64] out. The patch (5.3 KB a row) never reaches device memory.
// -fmad=false keeps every multiply and add separately rounded, so each row
// equals patch_cuda.rotated_goh_plain's (or goh_plain's) bit for bit.
//
// What bounds it on an H100: the per-row chain of block-wide steps (six
// barriers for the sums, the splat's 1936 + 352 + 64 chains) at one row per
// block; device bytes are the touched voxels and 64 B a row out.

#include "common.cuh"

namespace {

using namespace sift3d;

// spatial_weight_table()[v][bin] (MultiScale.cpp:639-671): positions 0..4
// lie in bin 0, position 5 splits half and half, 6..10 lie in bin 1.
__device__ __forceinline__ float spatial_weight(int v, int bin) {
  return v < kPatchRad ? (bin == 0 ? 1.0f : 0.0f) : v > kPatchRad ? (bin == 1 ? 1.0f : 0.0f) : 0.5f;
}

template <bool kSample>
__global__ void __launch_bounds__(sift3d::kRowThreads)
goh_kernel(const float* __restrict__ g, const int* __restrict__ lvl,
           const float* __restrict__ centers, const float* __restrict__ scales,
           const float* __restrict__ oris, const float* __restrict__ patches,
           uint8_t* __restrict__ out, int L, int Z, int Y, int X, int z0, int depth) {
  constexpr int kD = kPatchDim;
  __shared__ float p[kPatchVox];
  __shared__ float mag[kPatchVox];
  __shared__ uint8_t obin[kPatchVox];
  __shared__ float h1[kD * kD * 8 * 2];  // [z][y][o][d]
  __shared__ float h2[kD * 2 * 8 * 2];   // [z][b][o][d]
  __shared__ float h3[64];               // [a][b][d][o]
  __shared__ float red[kRowThreads];
  __shared__ float inv[9];
  const int r = blockIdx.x;
  if (kSample) {
    const int l = lvl[r];
    if (l < 0 || l >= L) {  // as K4: the patch is NaN (the tables never give such a row)
      for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) p[t] = NAN;
    } else {
      if (threadIdx.x == 0) invert_3x3(oris + (size_t)r * 9, inv);
      __syncthreads();
      const float fac = 2.0f * scales[r] / 5.0f;
      const float cx = centers[r * 3 + 0], cy = centers[r * 3 + 1], cz = centers[r * 3 + 2];
      const float* gl = g + (size_t)l * Z * Y * X;
      for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x)
        p[t] = rotated_point(gl, inv, fac, cx, cy, cz, t, Z, Y, X, z0, depth);
    }
  } else {
    for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) p[t] = patches[(size_t)r * kPatchVox + t];
  }
  __syncthreads();
  normalize_patch(p, red);
  for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) {
    float gx, gy, gz;
    patch_gradient(p, t, gx, gy, gz);
    const float m = sqrtf(gx * gx + gy * gy + gz * gz);
    // dots with the cube corners (+-1, +-1, +-1), x sign slowest; first max
    int best = 0;
    float top = 0.0f;
    for (int o = 0; o < 8; ++o) {
      const float dx = (o & 4) ? -1.0f : 1.0f, dy = (o & 2) ? -1.0f : 1.0f, dz = (o & 1) ? -1.0f : 1.0f;
      const float dot = gx * dx + gy * dy + gz * dz;
      if (o == 0 || dot > top) {
        top = dot;
        best = o;
      }
    }
    obin[t] = (uint8_t)best;
    mag[t] = m > 0.0f ? m : 0.0f;
  }
  __syncthreads();
  // x: h1[z][y][o][d] = sum_x (onehot * mag) * w[x][d]
  for (int q = threadIdx.x; q < kD * kD * 16; q += blockDim.x) {
    const int zy = q / 16, o = (q / 2) % 8, d = q % 2;
    float acc = 0.0f;
    for (int x = 0; x < kD; ++x) {
      const int i = zy * kD + x;
      const float w = (obin[i] == o ? 1.0f : 0.0f) * mag[i];
      acc = acc + w * spatial_weight(x, d);
    }
    h1[q] = acc;
  }
  __syncthreads();
  // y: h2[z][b][o][d] = sum_y h1[z][y][o][d] * w[y][b]
  for (int q = threadIdx.x; q < kD * 32; q += blockDim.x) {
    const int z = q / 32, b = (q / 16) % 2, od = q % 16;
    float acc = 0.0f;
    for (int y = 0; y < kD; ++y) acc = acc + h1[(z * kD + y) * 16 + od] * spatial_weight(y, b);
    h2[q] = acc;
  }
  __syncthreads();
  // z: h3[a][b][d][o] = sum_z h2[z][b][o][d] * w[z][a]
  if (threadIdx.x < 64) {
    const int a = threadIdx.x / 32, b = (threadIdx.x / 16) % 2, d = (threadIdx.x / 8) % 2,
              o = threadIdx.x % 8;
    float acc = 0.0f;
    for (int z = 0; z < kD; ++z) acc = acc + h2[((z * 2 + b) * 8 + o) * 2 + d] * spatial_weight(z, a);
    h3[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    float mn = nan_min(h3[l], h3[l + 32]);
    for (int h = 16; h >= 1; h >>= 1) mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, h));
    const float s0 = h3[l] - mn, s1 = h3[l + 32] - mn;
    const float norm = sqrtf(warp_tree_sum_64(s0 * s0, s1 * s1));
    const float den = norm > 0.0f ? norm : 1.0f;
    const float v0 = s0 / den, v1 = s1 / den;
    __syncwarp();
    h3[l] = v0;
    h3[l + 32] = v1;
    __syncwarp();
    int k0 = 0, k1 = 0;
    for (int j = 0; j < 64; ++j) {
      const float v = h3[j];
      k0 += (v < v0) || (v == v0 && j < l);
      k1 += (v < v1) || (v == v1 && j < l + 32);
    }
    out[(size_t)r * 64 + l] = (uint8_t)k0;
    out[(size_t)r * 64 + l + 32] = (uint8_t)k1;
  }
}

}  // namespace

extern "C" int sift3d_rotated_goh(const float* g, const int* lvl, const float* centers,
                                  const float* scales, const float* oris, uint8_t* out, int R, int L,
                                  int Z, int Y, int X, int z0, int depth, int device, void* stream) {
  SIFT3D_LAUNCH(device, goh_kernel<true>, dim3(R), dim3(sift3d::kRowThreads), stream, g, lvl, centers,
                scales, oris, nullptr, out, L, Z, Y, X, z0, depth);
}

extern "C" int sift3d_goh(const float* patches, uint8_t* out, int R, int device, void* stream) {
  SIFT3D_LAUNCH(device, goh_kernel<false>, dim3(R), dim3(sift3d::kRowThreads), stream, nullptr, nullptr,
                nullptr, nullptr, nullptr, patches, out, 0, 0, 0, 0, 0, 0);
}
