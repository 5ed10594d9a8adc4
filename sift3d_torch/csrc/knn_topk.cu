// M1: exact k-nearest neighbours under squared L2, streamed, with a fixed
// tie order.
//
// Replaces the XLA program of sift3d/match/knn.py: knn_search (the
// distance matrix |q|^2 + |d|^2 - 2 q.d as one MXU einsum, then
// lax.top_k) and knn_search_tiled (its host tiling and power-of-two shape
// buckets). Not a Pallas kernel in the JAX package. For each query row it
// returns the k smallest
//   d(q, j) = max((|q|^2 + |d_j|^2) - 2 (q . d_j), 0)
// ascending by (distance, database index): lax.top_k's order, the lowest
// index first among equal distances. Descriptors read from a .key file are
// integers, so distances are exact integers and ties are common: the tie
// order is the contract. The sums are in the order of XLA's CPU code for
// the JAX kNN, so that the 67-column rows of -g (integer descriptors and
// three float geometry columns, whose distances cancel to a few ulps of
// the norms) come out bit for bit as the JAX package's: the dot product an
// fma chain over the columns in order, acc = fmaf(q[c], d[c], acc) from 0
// (Eigen's), each norm window_sq_norm's (XLA's windowed reduce). The plain
// version, knn_cuda.dist_sqr_plain, computes the same (its fmas exact).
//
// What bounds it on an H100: f32 operations. Q * N * C fmas (at 48,000
// rows and C = 64 about 295 GFLOP, 4.4 ms at 67 TFLOP/s); the bytes
// (Q + N) * C * 4 are small next to that, and the [Q, N] matrix is never
// written.
//
// Design: one query a thread, its C values in registers; a block of 128
// queries streams the database through shared memory 128 rows at a time,
// with each row's norm computed once per tile. Every thread reads the same
// row at the same time (a broadcast, 16 bytes a load), and runs four rows'
// chains together for latency. The k best are a sorted register list of
// KM >= k slots (a compile-time size, so it stays in registers); a row
// enters only when strictly below the last slot and bubbles down with a
// strict compare, so among equal distances the earlier index, scanned
// first, stays first. The first k slots are the answer.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kTile = 128;     // database rows per shared-memory tile

template <int KM>
__device__ __forceinline__ void insert(float (&bd)[KM], int (&bi)[KM], float d, int j) {
  if (!(d < bd[KM - 1])) return;
  bd[KM - 1] = d;
  bi[KM - 1] = j;
#pragma unroll
  for (int s = KM - 1; s > 0; --s) {
    if (bd[s] < bd[s - 1]) {
      const float td = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = td;
      const int ti = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ti;
    }
  }
}

template <int C, int KM>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ q, const float* __restrict__ db, float* __restrict__ out_d,
                long long* __restrict__ out_i, int Q, int N, int k) {
  constexpr int RS = (C + 3) / 4 * 4 + 4;  // shared row stride: float4 aligned, padded
  __shared__ __align__(16) float tile[kTile * RS];
  __shared__ float tile_n[kTile];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kThreads + tid;
  const bool active = qi < Q;

  float qv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) qv[c] = active ? q[(size_t)qi * C + c] : 0.0f;
  const float qn = sift3d::window_sq_norm<C>([&](int c) { return qv[c]; });
  float bd[KM];
  int bi[KM];
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }

  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int nr = min(kTile, N - j0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < nr * C; e += kThreads) {
      const int r = e / C, c = e % C;
      tile[r * RS + c] = db[(size_t)(j0 + r) * C + c];
    }
    __syncthreads();
    if (tid < nr) tile_n[tid] = sift3d::window_sq_norm<C>([&](int c) { return tile[tid * RS + c]; });
    __syncthreads();
    for (int r = 0; r < nr; r += 4) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* row = tile + r * RS;
#pragma unroll
      for (int c = 0; c + 4 <= C; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v = *reinterpret_cast<const float4*>(row + u * RS + c);
          a[u] = fmaf(qv[c], v.x, a[u]);
          a[u] = fmaf(qv[c + 1], v.y, a[u]);
          a[u] = fmaf(qv[c + 2], v.z, a[u]);
          a[u] = fmaf(qv[c + 3], v.w, a[u]);
        }
      }
#pragma unroll
      for (int c = C / 4 * 4; c < C; ++c) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = fmaf(qv[c], row[u * RS + c], a[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (r + u < nr) {
          const float d = (qn + tile_n[r + u]) - 2.0f * a[u];
          insert<KM>(bd, bi, d > 0.0f ? d : 0.0f, j0 + r + u);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    if (s < k) {
      out_d[(size_t)qi * k + s] = bd[s];
      out_i[(size_t)qi * k + s] = bi[s];
    }
  }
}

template <int C, int KM>
int launch(const float* q, const float* db, float* out_d, long long* out_i, int Q, int N, int k,
           int device, void* stream) {
  auto kernel = knn_topk_kernel<C, KM>;
  SIFT3D_LAUNCH(device, kernel, dim3((Q + kThreads - 1) / kThreads), dim3(kThreads), stream, q, db,
                out_d, out_i, Q, N, k);
}

template <int C>
int launch_k(const float* q, const float* db, float* out_d, long long* out_i, int Q, int N, int k,
             int device, void* stream) {
  if (k <= 8) return launch<C, 8>(q, db, out_d, out_i, Q, N, k, device, stream);
  if (k <= 16) return launch<C, 16>(q, db, out_d, out_i, Q, N, k, device, stream);
  return launch<C, 32>(q, db, out_d, out_i, Q, N, k, device, stream);
}

}  // namespace

// q [Q, C], db [N, C] f32; out_d [Q, k] f32, out_i [Q, k] int64. C is 64
// (descriptors) or 67 (with -g's geometry columns); 1 <= k <= min(32, N).
extern "C" int sift3d_knn_topk(const float* q, const float* db, float* out_d, long long* out_i, int Q,
                               int N, int C, int k, int device, void* stream) {
  if (k < 1 || k > 32 || k > N) return (int)cudaErrorInvalidValue;
  if (C == 64) return launch_k<64>(q, db, out_d, out_i, Q, N, k, device, stream);
  if (C == 67) return launch_k<67>(q, db, out_d, out_i, Q, N, k, device, stream);
  return (int)cudaErrorInvalidValue;
}
