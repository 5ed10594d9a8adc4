// M1: exact k-nearest neighbours under squared L2, with a fixed tie order.
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
// Two routes, chosen by the caller from the data (knn_cuda.int8_route):
//
// The int8 route, for rows whose first 64 columns are integers in
// -128..127 (every .key descriptor, the extraction's GoH ranks 0..63, the
// descriptor part of -g's rows). Over those columns every step of the fma
// chain is exact (its partial sums are integers of at most 64 * 128^2 =
// 2^20 < 2^24), so the chain's value there is the integer dot product: an
// int8 tensor-core product with s32 accumulation
// (mma.sync.m16n8k32.row.col.s32.s8.s8.s32), converted to f32 exactly,
// gives the same bits. For C = 67 the three geometry columns follow as the
// same fmaf chain from that value. What bounds it on an H100:
// - int8 operations for the product, 2 Q N 64 (48,000 rows all to all:
//   295 G, 0.149 ms at 1,979 TOP/s), which the tensor cores now take;
// - f32 operations for the distance, (qn + dn) - 2 a, three a pair, and for
//   C = 67 the geometry tail's three fmas (six more): 0.10 and 0.31 ms at
//   67 TFLOP/s at 48,000 rows;
// - the selection epilogue: each of the Q N distances is compared with its
//   list's threshold (about 2.3 G compares at 48,000 rows), which no
//   tensor core does. This is what the kernel's time now follows.
// Design: a pre-pass (knn_prep_kernel) converts the database once to int8
// rows of 64 bytes, with each row's norm (window_sq_norm of its f32
// values) and, for C = 67, its three geometry columns beside it, padded
// with zero rows to a whole number of 128-row tiles. The main kernel
// (knn_topk_i8_kernel) gives each warp 16 queries, their int8 A fragments
// in registers for the whole run (8 registers); a block of 8 warps (128
// queries) streams its share of the database through shared memory with
// cp.async, two 128-row tiles in flight. The product's k order does not
// matter to an exact integer sum, so thread (g, t) of a warp holds bytes
// 16t..16t+15 of its rows, and one 16-byte shared load gives its B
// fragments for both k steps of an 8-row subtile (conflict-free at a
// 64-byte row stride). The epilogue stays in registers: each thread keeps
// a sorted list of KM slots (k rounded up to 5, 8, 16 or 32) for each of
// its fragment's two rows over the columns it holds (2 of every 8),
// rejects a distance with one compare against the list's last slot (for
// C = 64 in integers: the norms and the product are exact integers there,
// so dn - 2 acc <= last - qn is the same test, two instructions), and the
// four lists of a row are merged across the quad with shuffles at the
// end. Every compare, the reject test, the
// insert and the merges, is the lexicographic compare on (d, j): the
// indices are unique, so the k smallest are one set whatever order the
// threads and blocks see the rows in, and the result is lax.top_k's.
// Its registers (ptxas, sm_90a, at C = 64; 66 and 80 at C = 67): 76 and 79
// at KM 5 and 8, where __launch_bounds__ asks for two blocks an SM (a cap
// of 128), so three blocks of 256 threads fit an SM (uncapped, KM 5 takes
// 55 and runs 7% slower, scripts/torch_knn_variants.py); 127 at KM 16 (two
// blocks an SM) and 249 at KM 32 (one). When the queries fill less than
// half of the blocks the card holds at once (the occupancy API's count an
// SM, sift3d_knn_i8_blocks_per_sm, times the SMs: at k = 5 a quarter of
// 48,000 rows, as sharded_knn gives each of four entries, is 94 blocks for
// 396 places), the database is cut into S slices of whole tiles, S about
// places / blocks (knn_cuda.int8_plan), so that the blocks fill one wave:
// block (i, s) writes slice s's k best to scratch
// [S, Q, k], and knn_merge_kernel merges the slices by (d, j), one query a
// thread. So M1 is two launches on this route (prep, main), or three with
// slices (merge).
//
// The f32 route, for any other rows (no caller in the repo makes them; the
// API takes them): knn_topk_kernel, one query a thread on f32 fma chains.
// What bounds it: f32 operations, Q N C fmas (295 GFLOP at 48,000 rows and
// C = 64, 4.4 ms at 67 TFLOP/s); the [Q, N] matrix is never written. A
// block of 128 queries streams the database through shared memory 128
// rows at a time, with each row's norm computed once per tile; every
// thread reads the same row at the same time (a broadcast, 16 bytes a
// load) and runs four rows' chains together for latency. The k best are a
// sorted register list of KM >= k slots; a row enters only when strictly
// below the last slot and bubbles down with a strict compare, so among
// equal distances the earlier index, scanned first, stays first.

#include "common.cuh"

#include <limits.h>

namespace {

using sift3d::cp_async16;
using sift3d::cp_async_commit;
using sift3d::cp_async_wait;
using sift3d::mma_s8;
using sift3d::pack4;

// ---- the f32 route ----

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

// ---- the int8 route ----

constexpr int kWarps = 8;
constexpr int kI8Threads = kWarps * 32;  // 256
constexpr int kI8Queries = kWarps * 16;  // queries per block: one m16 tile a warp
constexpr int kI8Tile = 128;             // database rows per shared-memory stage (knn_cuda.INT8_TILE)
constexpr int kPrepThreads = 128;
constexpr int kMergeThreads = 128;
constexpr int kNoIndex = INT_MAX;  // an empty slot: (inf, INT_MAX) follows every real (d, j)

// (d, j) < (e, i), lexicographically
__device__ __forceinline__ bool before(float d, int j, float e, int i) { return d < e || (d == e && j < i); }

// Insert (d, j), already known to precede the last of the sorted list's KM
// slots, into the list. (The list's threshold is its last slot, a
// compile-time index: the k-th slot, a run-time index, would move the list
// out of registers; KM is k rounded up to 5, 8, 16 or 32.)
template <int KM>
__device__ __forceinline__ void insert_lex(float (&bd)[KM], int (&bi)[KM], float d, int j) {
  bd[KM - 1] = d;
  bi[KM - 1] = j;
#pragma unroll
  for (int s = KM - 1; s > 0; --s) {
    if (before(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      const float ed = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = ed;
      const int ei = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ei;
    }
  }
}

// db [N, C] f32 -> db8 [Npad, 64] int8, dn [Npad] (window_sq_norm of the
// f32 row), tail [Npad, 3] (C = 67: the geometry columns); rows N..Npad-1
// are zeros. One row a thread.
template <int C>
__global__ void __launch_bounds__(kPrepThreads)
knn_prep_kernel(const float* __restrict__ db, int* __restrict__ db8, float* __restrict__ dn,
                float* __restrict__ tail, int N, int Npad) {
  const int r = blockIdx.x * kPrepThreads + threadIdx.x;
  if (r >= Npad) return;
  const bool live = r < N;
  const float* row = db + (size_t)(live ? r : 0) * C;
  int4* out = reinterpret_cast<int4*>(db8 + (size_t)r * 16);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = live ? pack4(row + 16 * w + 4 * u) : 0;
    out[w] = make_int4(v[0], v[1], v[2], v[3]);
  }
  dn[r] = live ? sift3d::window_sq_norm<C>([&](int c) { return row[c]; }) : 0.0f;
  if (C > 64) {
#pragma unroll
    for (int c = 0; c < 3; ++c) tail[(size_t)r * 3 + c] = live ? row[64 + c] : 0.0f;
  }
}

// Block (i, s): queries 128 i .. 128 i + 127 against database slice s,
// rows [s * slice_rows, min(N, (s + 1) * slice_rows)). With one slice the
// k best go to out_d / out_i, else to part_d / part_i [S, Q, k].
template <int C, int KM>
__global__ void __launch_bounds__(kI8Threads, KM <= 8 ? 2 : 1)
knn_topk_i8_kernel(const float* __restrict__ q, const int* __restrict__ db8, const float* __restrict__ dn,
                   const float* __restrict__ tail, float* __restrict__ out_d, long long* __restrict__ out_i,
                   float* __restrict__ part_d, int* __restrict__ part_i, int Q, int N, int k, int slice_rows) {
  constexpr bool kTail = C > 64;
  __shared__ __align__(16) int tile8[2][kI8Tile * 16];
  __shared__ __align__(16) float tile_n[2][kI8Tile];
  __shared__ __align__(16) float tile_t[2][kTail ? kI8Tile * 3 : 4];
  __shared__ float q_n[kI8Queries];                   // the block's query norms
  __shared__ float q_t[kTail ? kI8Queries * 3 : 1];  // and geometry columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragment's group (row) and thread in group
  const int j_begin = blockIdx.y * slice_rows;
  const int j_end = min(N, j_begin + slice_rows);
  const int q0 = blockIdx.x * kI8Queries;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // the padded arrays hold every tile whole
  auto stage = [&](int buf, int j0) {
    const int* src = db8 + (size_t)j0 * 16;
    for (int e = tid; e < kI8Tile * 4; e += kI8Threads) cp_async16(&tile8[buf][e * 4], src + e * 4);
    if (tid < kI8Tile / 4) cp_async16(&tile_n[buf][tid * 4], dn + j0 + tid * 4);
    if (kTail && tid < kI8Tile * 3 / 4) cp_async16(&tile_t[buf][tid * 4], tail + (size_t)j0 * 3 + tid * 4);
    cp_async_commit();
  };
  const int ntiles = j_end > j_begin ? (j_end - j_begin + kI8Tile - 1) / kI8Tile : 0;
  if (ntiles > 0) stage(0, j_begin);

  // each query's norm once, a row a thread
  if (tid < kI8Queries) {
    const bool live = q0 + tid < Q;
    const float* qr = q + (size_t)(live ? q0 + tid : 0) * C;
    q_n[tid] = live ? sift3d::window_sq_norm<C>([&](int c) { return qr[c]; }) : 0.0f;
    if (kTail) {
#pragma unroll
      for (int c = 0; c < 3; ++c) q_t[tid * 3 + c] = live ? qr[64 + c] : 0.0f;
    }
  }
  // A fragments of m16n8k32 (a0, a2: row g; a1, a3: row g + 8)
  int a[2][4];
  sift3d::query_fragments(q, C, q0 + warp * 16, Q, a);
  __syncthreads();
  float qn[2], qt[2][3];
  int lim[2];  // C = 64: the last slot's distance in integers, less qn (INT_MAX while it is inf)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = warp * 16 + g + 8 * r;
    qn[r] = q_n[e];
#pragma unroll
    for (int c = 0; c < 3; ++c) qt[r][c] = kTail ? q_t[e * 3 + c] : 0.0f;
    lim[r] = INT_MAX;
  }

  float bd[2][KM];
  int bi[2][KM];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < KM; ++s) {
      bd[r][s] = INFINITY;
      bi[r][s] = kNoIndex;
    }
  }

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, j0 = j_begin + it * kI8Tile;
    if (it + 1 < ntiles) {
      stage(buf ^ 1, j0 + kI8Tile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nr = min(kI8Tile, j_end - j0);
    for (int n0 = 0; n0 < nr; n0 += 8) {
      const int4 b = *reinterpret_cast<const int4*>(&tile8[buf][(n0 + g) * 16 + 4 * t]);
      int acc[4] = {0, 0, 0, 0};
      mma_s8(acc, a[0], b.x, b.y);
      mma_s8(acc, a[1], b.z, b.w);
      // acc[u]: row r = u / 2 (g or g + 8), column n0 + 2t + u % 2
      const float2 dn2 = *reinterpret_cast<const float2*>(&tile_n[buf][n0 + 2 * t]);
      const int dni[2] = {__float2int_rn(dn2.x), __float2int_rn(dn2.y)};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = u >> 1, jl = n0 + 2 * t + (u & 1);
        // C = 64: the norms and the product are integers below 2^21, so the
        // f32 distance is max(qn + dn - 2 acc, 0) exactly, and it reaches
        // the last slot only if dn - 2 acc <= that slot - qn: one integer test
        if (jl < nr && (kTail || dni[u & 1] - 2 * acc[u] <= lim[r])) {
          float dot = (float)acc[u];  // exact: |acc| <= 2^20
          if (kTail) {
            const float* dt = &tile_t[buf][jl * 3];
            dot = fmaf(qt[r][0], dt[0], dot);
            dot = fmaf(qt[r][1], dt[1], dot);
            dot = fmaf(qt[r][2], dt[2], dot);
          }
          float d = (qn[r] + ((u & 1) ? dn2.y : dn2.x)) - 2.0f * dot;
          d = d > 0.0f ? d : 0.0f;
          const int j = j0 + jl;
          if (d <= bd[r][KM - 1] && before(d, j, bd[r][KM - 1], bi[r][KM - 1])) {
            insert_lex<KM>(bd[r], bi[r], d, j);
            lim[r] = bd[r][KM - 1] < INFINITY ? (int)bd[r][KM - 1] - (int)qn[r] : INT_MAX;
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is staged again
  }

  // merge the four lists of each row across the quad: t = 0, 2 take the k
  // best of t + 1, then t = 0 takes those of t = 2. A sender passes its
  // head and shifts its list up by one, k times; the receiver inserts what
  // precedes its last slot (one insert a row and round keeps the code small
  // at KM = 32)
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const bool take = (t & (2 * m - 1)) == 0, give = (t & (2 * m - 1)) == m;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll 1
      for (int s = 0; s < k; ++s) {
        const float d = __shfl_xor_sync(0xffffffffu, bd[r][0], m);
        const int j = __shfl_xor_sync(0xffffffffu, bi[r][0], m);
        if (give) {
#pragma unroll
          for (int e = 0; e + 1 < KM; ++e) {
            bd[r][e] = bd[r][e + 1];
            bi[r][e] = bi[r][e + 1];
          }
        }
        if (take && before(d, j, bd[r][KM - 1], bi[r][KM - 1])) insert_lex<KM>(bd[r], bi[r], d, j);
      }
    }
  }
  if (t != 0) return;
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Q) continue;
#pragma unroll
    for (int s = 0; s < KM; ++s) {
      if (s >= k) continue;
      if (split) {
        const size_t o = ((size_t)blockIdx.y * Q + row[r]) * k + s;
        part_d[o] = bd[r][s];
        part_i[o] = bi[r][s];
      } else {
        out_d[(size_t)row[r] * k + s] = bd[r][s];
        out_i[(size_t)row[r] * k + s] = bi[r][s];
      }
    }
  }
}

// The k best of S sorted slice lists part [S, Q, k] by (d, j), one query a
// thread.
template <int KM>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i, float* __restrict__ out_d,
                 long long* __restrict__ out_i, int Q, int S, int k) {
  const int qi = blockIdx.x * kMergeThreads + threadIdx.x;
  if (qi >= Q) return;
  float bd[KM];
  int bi[KM];
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    bd[s] = INFINITY;
    bi[s] = kNoIndex;
  }
  for (int sl = 0; sl < S; ++sl) {
    const size_t o = ((size_t)sl * Q + qi) * k;
    for (int e = 0; e < k; ++e) {
      const float d = part_d[o + e];
      const int j = part_i[o + e];
      if (!before(d, j, bd[KM - 1], bi[KM - 1])) break;  // the slice's list is sorted: the rest follow too
      insert_lex<KM>(bd, bi, d, j);
    }
  }
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    if (s < k) {
      out_d[(size_t)qi * k + s] = bd[s];
      out_i[(size_t)qi * k + s] = bi[s];
    }
  }
}

template <int C>
int launch_prep(const float* db, int* db8, float* dn, float* tail, int N, int Npad, int device, void* stream) {
  auto kernel = knn_prep_kernel<C>;
  SIFT3D_LAUNCH(device, kernel, dim3((Npad + kPrepThreads - 1) / kPrepThreads), dim3(kPrepThreads), stream, db,
                db8, dn, tail, N, Npad);
}

template <int C, int KM>
int launch_i8(const float* q, const int* db8, const float* dn, const float* tail, float* out_d, long long* out_i,
              float* part_d, int* part_i, int Q, int N, int k, int slices, int slice_rows, int device,
              void* stream) {
  auto kernel = knn_topk_i8_kernel<C, KM>;
  SIFT3D_LAUNCH(device, kernel, dim3((Q + kI8Queries - 1) / kI8Queries, slices), dim3(kI8Threads), stream, q,
                db8, dn, tail, out_d, out_i, part_d, part_i, Q, N, k, slice_rows);
}

template <int C>
int launch_i8_k(const float* q, const int* db8, const float* dn, const float* tail, float* out_d,
                long long* out_i, float* part_d, int* part_i, int Q, int N, int k, int slices, int slice_rows,
                int device, void* stream) {
  if (k <= 5)
    return launch_i8<C, 5>(q, db8, dn, tail, out_d, out_i, part_d, part_i, Q, N, k, slices, slice_rows, device,
                           stream);
  if (k <= 8)
    return launch_i8<C, 8>(q, db8, dn, tail, out_d, out_i, part_d, part_i, Q, N, k, slices, slice_rows, device,
                           stream);
  if (k <= 16)
    return launch_i8<C, 16>(q, db8, dn, tail, out_d, out_i, part_d, part_i, Q, N, k, slices, slice_rows, device,
                            stream);
  return launch_i8<C, 32>(q, db8, dn, tail, out_d, out_i, part_d, part_i, Q, N, k, slices, slice_rows, device,
                          stream);
}

template <int KM>
int launch_merge(const float* part_d, const int* part_i, float* out_d, long long* out_i, int Q, int S, int k,
                 int device, void* stream) {
  auto kernel = knn_merge_kernel<KM>;
  SIFT3D_LAUNCH(device, kernel, dim3((Q + kMergeThreads - 1) / kMergeThreads), dim3(kMergeThreads), stream,
                part_d, part_i, out_d, out_i, Q, S, k);
}

template <int C, int KM>
int occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, knn_topk_i8_kernel<C, KM>, kI8Threads, 0);
}

template <int C>
int occupancy_k(int k, int* blocks) {
  if (k <= 5) return occupancy<C, 5>(blocks);
  if (k <= 8) return occupancy<C, 8>(blocks);
  if (k <= 16) return occupancy<C, 16>(blocks);
  return occupancy<C, 32>(blocks);
}

}  // namespace

// The f32 route. q [Q, C], db [N, C] f32; out_d [Q, k] f32, out_i [Q, k]
// int64. C is 64 (descriptors) or 67 (with -g's geometry columns);
// 1 <= k <= min(32, N).
extern "C" int sift3d_knn_topk(const float* q, const float* db, float* out_d, long long* out_i, int Q,
                               int N, int C, int k, int device, void* stream) {
  if (k < 1 || k > 32 || k > N) return (int)cudaErrorInvalidValue;
  if (C == 64) return launch_k<64>(q, db, out_d, out_i, Q, N, k, device, stream);
  if (C == 67) return launch_k<67>(q, db, out_d, out_i, Q, N, k, device, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 route's pre-pass. db [N, C] f32 whose first 64 columns are
// integers in -128..127 -> db8 [Npad, 64] int8 (as int32 words), dn [Npad]
// f32, tail [Npad, 3] f32 (C = 67 only; may be null for C = 64); Npad a
// multiple of 128 >= N.
extern "C" int sift3d_knn_prep_i8(const float* db, int* db8, float* dn, float* tail, int N, int Npad, int C,
                                  int device, void* stream) {
  if (Npad < N || Npad % kI8Tile != 0) return (int)cudaErrorInvalidValue;
  if (C == 64) return launch_prep<64>(db, db8, dn, tail, N, Npad, device, stream);
  if (C == 67) return launch_prep<67>(db, db8, dn, tail, N, Npad, device, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 route's main kernel. q [Q, C] f32 (first 64 columns integers in
// -128..127), the pre-pass's db8, dn, tail; slices >= 1 slices of
// slice_rows rows (a multiple of 128) covering N. slices == 1: out_d [Q, k]
// f32, out_i [Q, k] int64; else part_d [S, Q, k] f32, part_i [S, Q, k]
// int32 for sift3d_knn_merge. 1 <= k <= min(32, N).
extern "C" int sift3d_knn_topk_i8(const float* q, const int* db8, const float* dn, const float* tail,
                                  float* out_d, long long* out_i, float* part_d, int* part_i, int Q, int N, int C,
                                  int k, int slices, int slice_rows, int device, void* stream) {
  if (k < 1 || k > 32 || k > N || slices < 1 || slice_rows % kI8Tile != 0 || slice_rows < kI8Tile ||
      (long long)slices * slice_rows < N)
    return (int)cudaErrorInvalidValue;
  if (C == 64)
    return launch_i8_k<64>(q, db8, dn, tail, out_d, out_i, part_d, part_i, Q, N, k, slices, slice_rows, device,
                           stream);
  if (C == 67)
    return launch_i8_k<67>(q, db8, dn, tail, out_d, out_i, part_d, part_i, Q, N, k, slices, slice_rows, device,
                           stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 main kernel's blocks an SM holds at once for C and k (the
// occupancy API's count for its registers and shared memory), in *blocks.
extern "C" int sift3d_knn_i8_blocks_per_sm(int C, int k, int* blocks, int device, void* stream) {
  (void)stream;
  if (k < 1 || k > 32 || (C != 64 && C != 67)) return (int)cudaErrorInvalidValue;
  const cudaError_t set_err = cudaSetDevice(device);
  if (set_err != cudaSuccess) return (int)set_err;
  if (C == 64) return occupancy_k<64>(k, blocks);
  return occupancy_k<67>(k, blocks);
}

// The slices' merge: part_d [S, Q, k] f32, part_i [S, Q, k] int32, each
// [s, q] list sorted by (d, j) -> out_d [Q, k] f32, out_i [Q, k] int64.
extern "C" int sift3d_knn_merge(const float* part_d, const int* part_i, float* out_d, long long* out_i, int Q,
                                int S, int k, int device, void* stream) {
  if (k < 1 || k > 32 || S < 1) return (int)cudaErrorInvalidValue;
  if (k <= 5) return launch_merge<5>(part_d, part_i, out_d, out_i, Q, S, k, device, stream);
  if (k <= 8) return launch_merge<8>(part_d, part_i, out_d, out_i, Q, S, k, device, stream);
  if (k <= 16) return launch_merge<16>(part_d, part_i, out_d, out_i, Q, S, k, device, stream);
  return launch_merge<32>(part_d, part_i, out_d, out_i, Q, S, k, device, stream);
}
