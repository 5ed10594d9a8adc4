// K3: blurred 11^3 orientation histogram -> top-k strict peaks.
//
// Replaces the Pallas kernel sift3d/kernels/hist_pallas.py:
// smooth_histogram_topk (_hist_topk_kernel). Per row c of V weighted
// points at bin coordinates (bin i's centre at i; the Pallas kernel takes
// them + 0.5): trilinear splat into an 11^3 histogram, zero-border Gaussian blur,
// strict interior 26-neighbour peaks, the k largest by repeated max with the
// lowest flat index first on ties (lax.top_k's order). Output row [k, 16]:
// lane 0 the peak value (-inf when no peak is left), lanes 1-6 the blurred
// histogram at x-1, x+1, y-1, y+1, z-1, z+1, lane 7 the flat position
// (z * 11 + y) * 16 + x, lanes 8-15 zero. An empty slot sits at (1, 1, 1).
//
// What bounds it on an H100: arithmetic, not memory. A row reads only
// 4 * V floats (V = 485) but forms 1331 * V products.
//
// Design: one block per row; the histogram lives in shared memory. Splat
// and blur are separable, so each point contributes
//   (w * fz[z]) * (fy[y] * fx[x])
// with per-axis blurred factors f = w0 * B[i0] + (1 - w0) * B[i0 + 1]
// (the JAX CPU path's form, features.py:109-175). Points are staged in
// shared memory 128 at a time; each thread owns up to 6 bins, accumulates
// a chunk's points in index order with fused multiply-adds and adds the
// chunk sum to the bin: the order in which the JAX package's CPU path sums
// (its 128-point einsum chunks), so the two agree to the bit. No float
// atomics: the order is fixed, so results repeat from run to run (atomics
// would reorder the sums and flip near-threshold orientation peaks).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBinsPerThread = (sift3d::kPatchVox + kThreads - 1) / kThreads;  // 6
constexpr int kChunk = 128;  // points staged per pass
constexpr int kLanes = 16;   // output lanes per peak
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
hist_topk_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                 const float* __restrict__ cz, const float* __restrict__ w,
                 const float* __restrict__ band, float* __restrict__ out, int V, int k) {
  using namespace sift3d;
  constexpr int P = kPatchDim;
  __shared__ float band_s[P * P];
  __shared__ float fx[kChunk][P], fy[kChunk][P], fz[kChunk][P];
  __shared__ float hist[kPatchVox];
  __shared__ float pk[kPatchVox];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int sel_s;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)c * V;
  for (int i = tid; i < P * P; i += kThreads) band_s[i] = band[i];

  float acc[kBinsPerThread];
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) acc[j] = 0.0f;

  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();  // band_s ready / previous chunk consumed
    for (int e = tid; e < 3 * nv; e += kThreads) {
      const int v = e / 3, a = e % 3;
      const float u = (a == 0 ? cx : (a == 1 ? cy : cz))[row + v0 + v];
      int i0;
      float w0;
      interp_bin(u, P, i0, w0);
      const float w1 = 1.0f - w0;
      const float wv = w[row + v0 + v];
      float* f = a == 0 ? fx[v] : (a == 1 ? fy[v] : fz[v]);
      for (int o = 0; o < P; ++o) {
        const float val = w0 * band_s[i0 * P + o] + w1 * band_s[(i0 + 1) * P + o];
        f[o] = a == 2 ? wv * val : val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int b = tid + j * kThreads;
      if (b < kPatchVox) {
        const int z = b / (P * P), y = (b / P) % P, x = b % P;
        float s = 0.0f;
        for (int v = 0; v < nv; ++v) s = fmaf(fz[v][z], fy[v][y] * fx[v][x], s);
        acc[j] = acc[j] + s;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    const int b = tid + j * kThreads;
    if (b < kPatchVox) hist[b] = acc[j];
  }
  __syncthreads();

  // strict interior 26-neighbour peaks; everything else is -inf
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    const int b = tid + j * kThreads;
    if (b >= kPatchVox) continue;
    const int z = b / (P * P), y = (b / P) % P, x = b % P;
    float p = -INFINITY;
    if (z >= 1 && z <= P - 2 && y >= 1 && y <= P - 2 && x >= 1 && x <= P - 2) {
      const float h = hist[b];
      bool peak = true;
      for (int dz = -1; dz <= 1; ++dz)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            if (dz == 0 && dy == 0 && dx == 0) continue;
            peak = peak && (h > hist[b + (dz * P + dy) * P + dx]);
          }
      if (peak) p = h;
    }
    pk[b] = p;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int s = 0; s < k; ++s) {
    // arg-max, lowest flat index first among equal values
    float bv = -INFINITY;
    int bi = kPatchVox;
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int b = tid + j * kThreads;
      if (b < kPatchVox) {
        const float p = pk[b];
        if (p > bv || (p == bv && b < bi)) {
          bv = p;
          bi = b;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      bv = red_v[0];
      bi = red_i[0];
      for (int q = 1; q < kWarps; ++q) {
        if (red_v[q] > bv || (red_v[q] == bv && red_i[q] < bi)) {
          bv = red_v[q];
          bi = red_i[q];
        }
      }
      const bool valid = bv > -INFINITY;
      int z = 1, y = 1, x = 1;
      if (valid) {
        z = bi / (P * P);
        y = (bi / P) % P;
        x = bi % P;
      }
      const int b = (z * P + y) * P + x;
      float* o = out + ((size_t)c * k + s) * kLanes;
      o[0] = bv;
      o[1] = hist[b - 1];
      o[2] = hist[b + 1];
      o[3] = hist[b - P];
      o[4] = hist[b + P];
      o[5] = hist[b - P * P];
      o[6] = hist[b + P * P];
      o[7] = (float)((z * P + y) * kLanes + x);
      for (int q = 8; q < kLanes; ++q) o[q] = 0.0f;
      sel_s = valid ? bi : -1;
    }
    __syncthreads();
    if (tid == 0 && sel_s >= 0) pk[sel_s] = -INFINITY;
    __syncthreads();
  }
}

}  // namespace

extern "C" int sift3d_hist_topk(const float* cx, const float* cy, const float* cz,
                                const float* w, const float* band, float* out, int C, int V,
                                int k, int device, void* stream) {
  SIFT3D_LAUNCH(device, hist_topk_kernel, dim3(C), dim3(kThreads), stream, cx, cy, cz, w, band,
                out, V, k);
}
