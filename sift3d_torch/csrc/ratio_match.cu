// M2: nearest-neighbour ratio test with the reference's geometric-
// compatibility shuffle, the distance rows computed on the fly.
//
// Replaces the numpy program of sift3d/match/pairwise.py: ratio_match (the
// closed form over the full [Q, D] distance matrix from dist_sqr_matrix:
// argmin, prefix-minimum records, events E0/E1/E2).
// Not a Pallas kernel in the JAX package. Per query it runs the sequential
// state machine of msComputeNearestNeighborDistanceRatioInfo
// (featMatchUtilities.cpp:336-421,
// pairwise._ratio_match_sequential_oracle), which is the same function as
// the closed form of the port's plain version (pairwise.ratio_rows_plain):
//   m1, m2 = the first two distances, swapped when the second is smaller;
//   for j >= 2, if d_j < m2: if d_j < m1 the old minimum moves to m2 when
//   db[j] is incompatible with it, and j becomes the minimum; otherwise j
//   becomes m2 when incompatible with the minimum.
// It returns the minimum's index (the earliest on ties: strict compares)
// and m1 / m2 (0 when m2 is 0). Distances are M1's (knn_topk.cu): an fma
// chain per dot product, windowed norms. compatible(j, i), the reference's
// sphere test: |log(s_j / s_i)| < log_thr and |xyz_j - xyz_i| < shift * s_j,
// with the distance the correctly rounded root of ((dx dx + dy dy) + dz dz)
// and the log computed in f64 and rounded to f32, as the plain version does.
//
// What bounds it on an H100: f32 operations, Q * D * 64 fmas (31
// sets of 1000 queries against 1000 rows: 2 GFLOP, 0.03 ms at 67
// TFLOP/s). The compatibility tests run only when a row improves on m2,
// about 2 ln D times a query.
//
// Design: M1's: one query a thread, its 64 values in registers, the
// database streamed through shared memory 128 rows a tile with each row's
// norm computed once, four rows' chains at a time. The state machine needs
// every row in index order, so each thread walks the tile in order; the
// compatibility partner (the current minimum) may lie in an earlier tile
// and is read from global memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kTile = 128;     // database rows per shared-memory tile
constexpr int kC = 64;         // descriptor columns
constexpr int kRS = kC + 4;    // shared row stride

__device__ __forceinline__ bool compatible(const float* __restrict__ xyz, const float* __restrict__ scale,
                                           int j, int i, float log_thr, float shift) {
  const float dx = xyz[3 * j] - xyz[3 * i];
  const float dy = xyz[3 * j + 1] - xyz[3 * i + 1];
  const float dz = xyz[3 * j + 2] - xyz[3 * i + 2];
  const float dist = sqrtf((dx * dx + dy * dy) + dz * dz);
  const float sdiff = fabsf((float)log((double)(scale[j] / scale[i])));
  return sdiff < log_thr && dist < shift * scale[j];
}

__global__ void __launch_bounds__(kThreads)
ratio_match_kernel(const float* __restrict__ q, const float* __restrict__ db, const float* __restrict__ xyz,
                   const float* __restrict__ scale, long long* __restrict__ out_idx,
                   float* __restrict__ out_ratio, int Q, int D, float log_thr, float shift) {
  __shared__ __align__(16) float tile[kTile * kRS];
  __shared__ float tile_n[kTile];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kThreads + tid;
  const bool active = qi < Q;

  float qv[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) qv[c] = active ? q[(size_t)qi * kC + c] : 0.0f;
  const float qn = sift3d::window_sq_norm<kC>([&](int c) { return qv[c]; });
  float m1 = 0.0f, m2 = 0.0f;
  int i1 = 0;

  for (int j0 = 0; j0 < D; j0 += kTile) {
    const int nr = min(kTile, D - j0);
    __syncthreads();
    for (int e = tid; e < nr * kC; e += kThreads) {
      const int r = e / kC, c = e % kC;
      tile[r * kRS + c] = db[(size_t)(j0 + r) * kC + c];
    }
    __syncthreads();
    if (tid < nr) tile_n[tid] = sift3d::window_sq_norm<kC>([&](int c) { return tile[tid * kRS + c]; });
    __syncthreads();
    for (int r = 0; r < nr; r += 4) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* row = tile + r * kRS;
#pragma unroll
      for (int c = 0; c < kC; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v = *reinterpret_cast<const float4*>(row + u * kRS + c);
          a[u] = fmaf(qv[c], v.x, a[u]);
          a[u] = fmaf(qv[c + 1], v.y, a[u]);
          a[u] = fmaf(qv[c + 2], v.z, a[u]);
          a[u] = fmaf(qv[c + 3], v.w, a[u]);
        }
      }
      if (!active) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + r + u;
        if (r + u >= nr) break;
        float d = (qn + tile_n[r + u]) - 2.0f * a[u];
        d = d > 0.0f ? d : 0.0f;
        if (j == 0) {
          m1 = d;
        } else if (j == 1) {
          if (d < m1) {
            m2 = m1;
            m1 = d;
            i1 = 1;
          } else {
            m2 = d;
          }
        } else if (d < m2) {
          const bool incompatible = !compatible(xyz, scale, j, i1, log_thr, shift);
          if (d < m1) {
            if (incompatible) m2 = m1;
            m1 = d;
            i1 = j;
          } else if (incompatible) {
            m2 = d;
          }
        }
      }
    }
  }
  if (!active) return;
  out_idx[qi] = i1;
  out_ratio[qi] = m2 > 0.0f ? m1 / m2 : 0.0f;
}

}  // namespace

// q [Q, 64], db [D, 64], xyz [D, 3], scale [D] f32; out_idx [Q] int64,
// out_ratio [Q] f32; D >= 2. log_thr and shift: the compatibility test's
// thresholds (ratio_compat_log_scale rounded to f32, ratio_compat_shift).
extern "C" int sift3d_ratio_match(const float* q, const float* db, const float* xyz, const float* scale,
                                  long long* out_idx, float* out_ratio, int Q, int D, float log_thr,
                                  float shift, int device, void* stream) {
  if (D < 2) return (int)cudaErrorInvalidValue;
  SIFT3D_LAUNCH(device, ratio_match_kernel, dim3((Q + kThreads - 1) / kThreads), dim3(kThreads), stream,
                q, db, xyz, scale, out_idx, out_ratio, Q, D, log_thr, shift);
}
