// M2: nearest-neighbour ratio test with the reference's geometric-
// compatibility shuffle, the distance rows computed on the fly.
//
// Replaces the numpy program of sift3d/match/pairwise.py: ratio_match (the
// closed form over the full [Q, D] distance matrix from dist_sqr_matrix:
// argmin, prefix-minimum records, events E0/E1/E2).
// Not a Pallas kernel in the JAX package. Per query it computes the
// sequential state machine of msComputeNearestNeighborDistanceRatioInfo
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
// Two routes, chosen by the caller from the data (knn_cuda.int8_route), as
// M1's are.
//
// The int8 route, for rows whose 64 columns are integers in -128..127 (every
// .key descriptor): M1's exactness argument (knn_topk.cu) holds, so an
// mma.sync s8 product gives the chain's dot product, and the distance
// (qn + dn) - 2 a is an exact integer below 64 * 255^2 < 2^22, computed in
// int32. The state machine is a scan followed by a minimum: with (m, i) the
// prefix minimum before row j (the lexicographic minimum of (d, index) over
// rows < j), row j's event value is m when d_j < m (a record: the old
// minimum is displaced) and d_j otherwise, and it counts when j == 1 (E0)
// or when j >= 2 and db[j] is incompatible with i; m2 is the smallest
// counted event, m1 the final prefix minimum. So the database is cut into
// segments of 16 rows, walked in parallel: each segment's minimum, an
// exclusive scan over the segments for the state that enters each, then
// each segment's walk from that state, keeping its smallest counted event.
// A compatibility test runs only for an event that would lower the smallest
// counted event known so far (a minimum does not change otherwise; E0, row
// 1's event, seeds it), and
// takes its f64 log only in a narrow band of scale ratios (CompatTest). The
// walk itself has no branch: it marks the events that may need a test, and
// then each lane tests its marked events smallest first at one call site
// (usually one test: the first incompatible event ends the segment's), so
// the lanes of a warp test together wherever their events lie (a test at
// each cell's own site ran divergently, each lane's tests in its own
// passes of the warp: 0.144 ms against 0.054 with no test, on an H100).
// What bounds it on an H100: bytes, the queries read once (f32) and the
// results written (30,039 queries against 969 rows: 7.9 MB, 0.0024 ms);
// the tensor-core product (2 Q D 64 int8 operations) and the distances and
// walk (a few integer operations a pair) are below that. Design: M1's
// pre-pass (knn_prep_kernel) converts the database to int8 rows with their
// norms; a block of four warps (64 queries, one m16 tile a warp, the A
// fragments in registers) streams the database through shared memory with
// cp.async, 128 rows a tile, two tiles in flight, each tile in two halves of
// 64 rows. The rows of a half are placed in the B columns so that thread t
// of each quad holds rows 16t .. 16t + 15 of the half (its segment) for the
// fragment's two query rows: the quad's exclusive scan of the segment
// minima is two shuffles, the walk runs over the thread's own registers in
// row order, the prefix minimum carries from half to half, and the quad
// shares its smallest event at the end of each half. Keys are d * 64 + the
// row's place in the half (d < 2^22), so a minimum of keys is the earliest
// minimum. The database's positions and scales (16 bytes a row) are staged
// in shared memory for the compatibility tests, or read from device memory
// for a database of more than kMaxGeoRows rows.
//
// The f32 route, for any other rows: one query a thread,
// its 64 values in registers, the database streamed through shared memory
// 128 rows a tile with each row's norm computed once, four rows' chains at
// a time, each thread walking the rows in order; the compatibility partner
// is read from device memory. What bounds it: f32 operations, Q * D * 64
// fmas (0.056 ms at 30,039 x 969).

#include "common.cuh"

#include <limits.h>

namespace {

using sift3d::cp_async16;
using sift3d::cp_async_commit;
using sift3d::cp_async_wait;
using sift3d::mma_s8;

constexpr int kThreads = 128;  // queries per block
constexpr int kTile = 128;     // database rows per shared-memory tile
constexpr int kC = 64;         // descriptor columns
constexpr int kRS = kC + 4;    // shared row stride

// Row j's (x, y, z, scale).
__device__ __forceinline__ float4 geometry(const float* __restrict__ xyz, const float* __restrict__ scale, int j) {
  return make_float4(xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2], scale[j]);
}

// compatible(j, i) for a = row j's geometry, b = row i's
__device__ __forceinline__ bool compatible(float4 a, float4 b, float log_thr, float shift) {
  const float dx = a.x - b.x;
  const float dy = a.y - b.y;
  const float dz = a.z - b.z;
  const float dist = sqrtf((dx * dx + dy * dy) + dz * dz);
  const float sdiff = fabsf((float)log((double)(a.w / b.w)));
  return sdiff < log_thr && dist < shift * a.w;
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
          const bool incompatible = !compatible(geometry(xyz, scale, j), geometry(xyz, scale, i1), log_thr, shift);
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

// ---- the int8 route ----

constexpr int kI8Warps = 4;
constexpr int kI8Threads = kI8Warps * 32;  // 128
constexpr int kI8Queries = kI8Warps * 16;  // queries a block: one m16 tile a warp
constexpr int kI8Tile = 128;               // database rows a shared-memory stage (knn_cuda.INT8_TILE)
constexpr int kHalf = 64;                  // rows a step of the walk: 8 subtiles of 8 columns
constexpr int kSeg = kHalf / 4;            // rows of a segment: a thread's share of a half
constexpr int kMaxGeoRows = 8192;          // databases up to this size keep their geometry in shared memory
constexpr int kNone = INT_MAX;             // no key, no event
constexpr int kPad = kNone >> 6;           // a padding row's distance: above every distance (< 2^22), a valid key
constexpr unsigned kFull = 0xffffffffu;

// |(float)log((double)r)| < log_thr, the scale part of compatible(). Not
// inlined: the int8 kernel reaches it only in a narrow band (CompatTest).
__device__ __noinline__ bool log_ratio_below(float r, float log_thr) {
  return fabsf((float)log((double)r)) < log_thr;
}

// compatible() with its scale part decided by r = s_j / s_i alone outside a
// band of relative width 2^-16 around e^-log_thr and e^log_thr: there |log r|
// lies at least 2^-16 from log_thr, far beyond the f32 rounding of the log
// (and the f64 log's error), so the test's answer is known; inside the band,
// and for thresholds whose bounds would not be normal floats, the f64 log.
// The same answers as compatible() on every input, for a fraction of its
// operations: a walk's tests run divergently, so their cost is the warp's.
struct CompatTest {
  float log_thr, shift, in_lo, in_hi, out_lo, out_hi;
  bool band;
  __device__ explicit CompatTest(float thr, float sh) : log_thr(thr), shift(sh) {
    const double e = exp((double)thr), k = 1.0 / 65536.0;
    band = thr > 0.0f && thr < 80.0f;  // e^80 and e^-80 are normal floats
    in_lo = (float)((1.0 + k) / e);
    in_hi = (float)((1.0 - k) * e);
    out_lo = (float)((1.0 - k) / e);
    out_hi = (float)((1.0 + k) * e);
  }
  // compatible(a, b, log_thr, shift)
  __device__ __forceinline__ bool operator()(float4 a, float4 b) const {
    const float dx = a.x - b.x;
    const float dy = a.y - b.y;
    const float dz = a.z - b.z;
    if (!(sqrtf((dx * dx + dy * dy) + dz * dz) < shift * a.w)) return false;
    const float r = a.w / b.w;
    if (band && r > in_lo && r < in_hi) return true;
    if (band && (r <= out_lo || r >= out_hi)) return false;
    return log_ratio_below(r, log_thr);
  }
};

// The lexicographic minimum of two prefix states (d, j) given as the
// current state and a key d * 64 + (j - base) of a later half-relative row:
// the key wins only when strictly smaller (its rows come later).
__device__ __forceinline__ void take_key(int& md, int& mj, int key, int base) {
  if (key != kNone && (key >> 6) < md) {
    md = key >> 6;
    mj = base + (key & (kHalf - 1));
  }
}

template <bool kGeoShared>
__global__ void __launch_bounds__(kI8Threads, 4)
ratio_i8_kernel(const float* __restrict__ q, const int* __restrict__ db8, const float* __restrict__ dn,
                const float* __restrict__ xyz, const float* __restrict__ scale, long long* __restrict__ out_idx,
                float* __restrict__ out_ratio, int Q, int D, float log_thr, float shift) {
  extern __shared__ float4 geo[];  // [D] (x, y, z, scale) when kGeoShared
  __shared__ __align__(16) int tile8[2][kI8Tile * 16];
  __shared__ __align__(16) float tile_n[2][kI8Tile];
  __shared__ float q_n[kI8Queries];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragment's group (row) and thread in group
  const int q0 = blockIdx.x * kI8Queries;
  const int ntiles = (D + kI8Tile - 1) / kI8Tile;

  // slot (s, n) of a tile (subtile s, B column n) holds row 64 (s / 8) +
  // 16 (n / 2) + 2 (s % 8) + n % 2 of it: the C fragment's columns 2t and
  // 2t + 1 of subtile s are rows 16t + 2 (s % 8) and + 1 of half s / 8. The
  // norms stay in row order. The pre-pass pads the rows to whole tiles.
  auto stage = [&](int buf, int j0) {
    for (int e = tid; e < kI8Tile * 4; e += kI8Threads) {
      const int slot = e >> 2, c = e & 3, s = slot >> 3, n = slot & 7;
      const int r = kHalf * (s >> 3) + kSeg * (n >> 1) + 2 * (s & 7) + (n & 1);
      cp_async16(&tile8[buf][slot * 16 + 4 * c], db8 + (size_t)(j0 + r) * 16 + 4 * c);
    }
    if (tid < kI8Tile / 4) cp_async16(&tile_n[buf][tid * 4], dn + j0 + tid * 4);
    cp_async_commit();
  };
  stage(0, 0);
  if (kGeoShared)
    for (int j = tid; j < D; j += kI8Threads) geo[j] = geometry(xyz, scale, j);
  if (tid < kI8Queries) {
    const bool live = q0 + tid < Q;
    const float* qr = q + (size_t)(live ? q0 + tid : 0) * 64;
    q_n[tid] = live ? sift3d::window_sq_norm<64>([&](int c) { return qr[c]; }) : 0.0f;
  }
  int a[2][4];
  sift3d::query_fragments(q, 64, q0 + warp * 16, Q, a);
  __syncthreads();
  const CompatTest compatible_rows(log_thr, shift);
  int qn[2], md[2], mj[2], best[2];  // norm; prefix minimum before the half; smallest counted event
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qn[r] = __float2int_rn(q_n[warp * 16 + g + 8 * r]);
    md[r] = kNone;
    mj[r] = -1;
    best[r] = kNone;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, j0 = it * kI8Tile;
    if (it + 1 < ntiles) {
      stage(buf ^ 1, j0 + kI8Tile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kI8Tile / kHalf; ++h) {
      const int base = j0 + kHalf * h;  // the half's first row
      if (base >= D) break;             // the same for the whole block
      const int seg0 = base + kSeg * t;  // this thread's segment: rows seg0 .. seg0 + 15
      int d[2][kSeg];  // the distances; after the walk each cell's event value
#pragma unroll
      for (int s8 = 0; s8 < 8; ++s8) {
        const int s = 8 * h + s8;
        const int4 b = *reinterpret_cast<const int4*>(&tile8[buf][(s * 8 + g) * 16 + 4 * t]);
        int acc[4] = {0, 0, 0, 0};
        mma_s8(acc, a[0], b.x, b.y);
        mma_s8(acc, a[1], b.z, b.w);
        // acc[u]: query row g + 8 (u / 2), database row seg0 + 2 s8 + u % 2
        const float2 dn2 = *reinterpret_cast<const float2*>(&tile_n[buf][kHalf * h + kSeg * t + 2 * s8]);
        const int dni[2] = {__float2int_rn(dn2.x), __float2int_rn(dn2.y)};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 2 * s8 + (u & 1);
          d[u >> 1][k] = seg0 + k < D ? max(qn[u >> 1] + dni[u & 1] - 2 * acc[u], 0) : kPad;
        }
      }
      if (base == 0) {
        // the event of row 1 (E0) counts unconditionally: it bounds the
        // smallest counted event from the start, for every segment
#pragma unroll
        for (int r = 0; r < 2; ++r)
          best[r] = __shfl_sync(kFull, max(d[r][0], d[r][1]), lane & ~3);  // thread t = 0's rows 0 and 1
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the segment's minimum as a key, then the quad's exclusive scan
        int key = kNone;
#pragma unroll
        for (int k = 0; k < kSeg; ++k) key = min(key, (d[r][k] << 6) | (kSeg * t + k));
        int incl = key, x = __shfl_up_sync(kFull, incl, 1, 4);
        if (t >= 1) incl = min(incl, x);
        x = __shfl_up_sync(kFull, incl, 2, 4);
        if (t >= 2) incl = min(incl, x);
        const int excl = __shfl_up_sync(kFull, incl, 1, 4);
        const int total = __shfl_sync(kFull, incl, 3, 4);
        // walk the segment in row order from the state that enters it: a
        // record (d < the state's distance) displaces the state's distance,
        // any other row offers its own, so a cell's event is max(d, state)
        // and the state becomes min(d, state). The records' places are
        // kept, for the partners; the events of rows >= 2 that may lower
        // the smallest counted one are marked (row 1's is in best)
        int sd = md[r], enter_j = mj[r];
        if (t >= 1) take_key(sd, enter_j, excl, base);
        unsigned records = 0, marked = 0;
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          const int v = d[r][k];
          records |= (unsigned)(v < sd) << k;
          d[r][k] = max(v, sd);
          sd = min(v, sd);
          marked |= (unsigned)(seg0 + k >= 2 && d[r][k] < best[r]) << k;
        }
        // the marked events' compatibility tests, smallest event first: the
        // first incompatible one is the smallest counted event of the
        // segment, and the rest cannot lower it. The lanes of the warp test
        // together, one call site. A cell's partner is the segment's last
        // record before it, else the entering state's row
        while (marked) {
          int k = 0, val = kNone;
#pragma unroll
          for (int c = 0; c < kSeg; ++c)
            if (((marked >> c) & 1u) && d[r][c] < val) {
              val = d[r][c];
              k = c;
            }
          marked &= ~(1u << k);
          if (val >= best[r]) break;
          const unsigned before = records & ((1u << k) - 1);
          const int j = seg0 + k, partner = before ? seg0 + 31 - __clz(before) : enter_j;
          const bool compatible = kGeoShared ? compatible_rows(geo[j], geo[partner])
                                             : compatible_rows(geometry(xyz, scale, j),
                                                               geometry(xyz, scale, partner));
          if (!compatible) {
            best[r] = val;
            break;
          }
        }
        take_key(md[r], mj[r], total, base);
        best[r] = min(best[r], __shfl_xor_sync(kFull, best[r], 1));
        best[r] = min(best[r], __shfl_xor_sync(kFull, best[r], 2));
      }
    }
    __syncthreads();  // this buffer is consumed before it is staged again
  }
  if (t != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Q) continue;
    out_idx[qi] = mj[r];
    // D >= 2: best holds the event of row 1 (E0) at least, a distance
    out_ratio[qi] = best[r] > 0 ? (float)md[r] / (float)best[r] : 0.0f;
  }
}

template <bool kGeoShared>
int launch_i8(const float* q, const int* db8, const float* dn, const float* xyz, const float* scale,
              long long* out_idx, float* out_ratio, int Q, int D, float log_thr, float shift, int device,
              void* stream) {
  const cudaError_t set_err = cudaSetDevice(device);
  if (set_err != cudaSuccess) return (int)set_err;
  const size_t geo_bytes = kGeoShared ? (size_t)D * sizeof(float4) : 0;
  // above the default 48 KB of shared memory a block, dynamic memory needs the opt-in
  const cudaError_t attr_err = cudaFuncSetAttribute(ratio_i8_kernel<kGeoShared>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo_bytes);
  if (attr_err != cudaSuccess) return (int)attr_err;
  ratio_i8_kernel<kGeoShared><<<dim3((Q + kI8Queries - 1) / kI8Queries), dim3(kI8Threads), geo_bytes,
                                (cudaStream_t)stream>>>(q, db8, dn, xyz, scale, out_idx, out_ratio, Q, D, log_thr,
                                                        shift);
  return (int)cudaGetLastError();
}

}  // namespace

// The int8 route. q [Q, 64] f32 whose values are integers in -128..127;
// db8 [Dpad, 64] int8 (as int32 words) and dn [Dpad] f32 from M1's pre-pass
// (sift3d_knn_prep_i8, C = 64; Dpad a multiple of 128 >= D); xyz [D, 3],
// scale [D] f32; out_idx [Q] int64, out_ratio [Q] f32; D >= 2.
extern "C" int sift3d_ratio_match_i8(const float* q, const int* db8, const float* dn, const float* xyz,
                                     const float* scale, long long* out_idx, float* out_ratio, int Q, int D,
                                     float log_thr, float shift, int device, void* stream) {
  if (D < 2) return (int)cudaErrorInvalidValue;
  if (D <= kMaxGeoRows)
    return launch_i8<true>(q, db8, dn, xyz, scale, out_idx, out_ratio, Q, D, log_thr, shift, device, stream);
  return launch_i8<false>(q, db8, dn, xyz, scale, out_idx, out_ratio, Q, D, log_thr, shift, device, stream);
}

// The f32 route. q [Q, 64], db [D, 64], xyz [D, 3], scale [D] f32; out_idx [Q] int64,
// out_ratio [Q] f32; D >= 2. log_thr and shift: the compatibility test's
// thresholds (ratio_compat_log_scale rounded to f32, ratio_compat_shift).
extern "C" int sift3d_ratio_match(const float* q, const float* db, const float* xyz, const float* scale,
                                  long long* out_idx, float* out_ratio, int Q, int D, float log_thr,
                                  float shift, int device, void* stream) {
  if (D < 2) return (int)cudaErrorInvalidValue;
  SIFT3D_LAUNCH(device, ratio_match_kernel, dim3((Q + kThreads - 1) / kThreads), dim3(kThreads), stream,
                q, db, xyz, scale, out_idx, out_ratio, Q, D, log_thr, shift);
}
