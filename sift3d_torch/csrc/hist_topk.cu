// K3: blurred 11^3 orientation histogram -> top-k strict peaks.
// K8: the raw (unblurred) splat histogram.  K9: the blurred histogram and its
// strict-peak plane.
//
// Replaces the Pallas kernels sift3d/kernels/hist_pallas.py:
// smooth_histogram_topk (_hist_topk_kernel, K3), splat_histogram_raw
// (_hist_kernel, K8) and smooth_histogram_peaks (_hist_peaks_kernel, K9).
// Per row c of V weighted points at bin coordinates (bin i's centre at i;
// the Pallas kernels take them + 0.5): trilinear splat into an 11^3
// histogram, zero-border Gaussian blur, strict interior 26-neighbour peaks,
// the k largest by repeated max with the lowest flat index first on ties
// (lax.top_k's order). K3's output row [k, 16]: lane 0 the peak value (-inf
// when no peak is left), lanes 1-6 the blurred histogram at x-1, x+1, y-1,
// y+1, z-1, z+1, lane 7 the flat position (z * 11 + y) * 16 + x, lanes 8-15
// zero. An empty slot sits at (1, 1, 1). K8 stops after the splat and writes
// the [C, 11, 11, 11] histogram; K9 stops after the peak mask and writes the
// blurred histogram and the peak plane (the histogram where a strict
// interior peak, -inf elsewhere), both [C, 11, 11, 11]: the TPU's padded
// [C, 128, 16] layout is an artifact of its (8, 128) tiling.
//
// The arithmetic is fixed. Splat and blur are separable, so each point adds
//   fz[z] * (fy[y] * fx[x])
// to bin (z, y, x), with per-axis blurred factors
// f = w0 * B[i0] + (1 - w0) * B[i0 + 1] and the point's weight applied on z
// (the JAX CPU path's form, features.py:109-175). K8 is the same with the
// identity as the band B, so each factor is one of the two trilinear weights
// exactly. Each bin sums the points of a 128-point chunk in index order as
// s = fma(fz, fy * fx, s), the product rounded on its own, and adds the chunk
// sum to its total: the order of the JAX package's CPU path (its 128-point
// einsum chunks), so the two agree to the bit. No float atomics and no other
// order: a reordered sum flips near-threshold orientation peaks.
//
// What bounds it on an H100: shared-memory load throughput. A row reads 4 * V
// floats but forms 1331 * V products; the outputs (1331 or 2 x 1331 floats
// a row) are small next to that. The products are cheap for the f32 pipe
// (about 0.08 ms for the T1 rows at 67 TFLOP/s); what costs is feeding
// them the factors. The first design (one bin per thread, 6 bins a thread)
// loaded fz, fy and fx from shared memory for every multiply-add: three
// shared loads per FMA, 1.14 ms on the T1 rows.
//
// Design: one row per 128-thread block. Thread (y, x) owns the column of
// 11 z bins in registers, so for each point it forms the product
// p = fy[y] * fx[x] once and runs 11 FMAs s[z] = fma(fz[z], p, s[z]), with
// fz read as three float4 broadcasts (every thread reads the same address):
// about 5 shared loads per 11 FMAs. A point's factors are staged by one
// thread, fx and fy point-fastest (129-float row stride, no bank
// conflicts), fz point-major. Skipping exact zeros: every factor and
// weight is >= 0 and finite, so a point whose product is 0 for a column
// adds fma(fz, 0, s) == s and a point with fz == 0 adds fma(0, p, s) == s.
// Each warp lists, per chunk and in index order, the points whose nonzero
// y factors meet the warp's y rows (a ballot per 32 points) and runs only
// those; the list is the same for every thread of the warp, and the
// chain's bits do not change. Under the sigma 0.5 band a point has 4
// nonzero factors per axis, under the identity band (K8) 2, so a warp
// skips about half the points (K3) or 60% (K8). The top-k: one warp
// compacts the peak plane (few peaks) in flat order, then takes k rounds
// of a warp arg-max with no block barrier. The three kernels share one
// body, templated on where it stops, so on the same rows K9's histogram is
// K3's and the top-k of K9's peak plane is K3's output bit for bit.
//
// The fused canonical stage (sift3d_canonical, two launches) runs the same
// body on points it forms in shared memory. It replaces the eager chain
// around K3 in sift3d_torch.pipeline.features.canonical_stage_plain
// (sphere_edges, splat_coords, hist_tops, the perpendicular projection,
// _norm_or_x, Gram-Schmidt and the cross product: about 800 launch calls
// a call and one host sync), the JAX package's features.canonical_stage
// (sift3d/pipeline/features.py:526-657) around smooth_histogram_topk.
//   A, one block per row: the row's normalized patch into shared memory,
//     its 485 in-sphere gradients in ascending flat index, their
//     magnitudes sqrt(fma(gz, gz, fma(gy, gy, gx * gx))) as weights and
//     unit directions e * 5 + 5 as bin coordinates; the body's top K1; per
//     slot the quadratic vertex, the 0.8 threshold and _norm_or_x: p1 and
//     its flag (& kvalid) in device scratch.
//   B, one block per (row, primary) slot: a dead slot writes zero frames;
//     a live one rebuilds the row's directions (cheaper than storing
//     [C, 3, 485]), projects them perpendicular to p1, runs the body for
//     the top K2, the 0.5 threshold, the vertex, Gram-Schmidt against p1
//     and the cross product, and writes all K2 frames of the slot.
// Stream order hands A's scratch to B: no nonzero and no host sync between
// them. Every multiply-add the plain version fuses (numerics.fma_exact) is
// an fmaf; sqrtf and / round correctly; -fmad=false keeps the rest
// separately rounded; so each output equals the plain stage's bit for bit.
// What bounds it: the body, once a row and once a live slot; a row's
// directions and frames are a few hundred operations beside it.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // one thread per (y, x) column; 121 used
constexpr int kChunk = 128;    // points per partial sum (hist_cuda.CHUNK)
constexpr int kPad = 12;       // a factor row padded to three float4
constexpr int kLanes = 16;     // output lanes per peak
constexpr int kSkip = 0xff;    // meta of a point no warp needs (lo 255 > hi 0)
// the peak plane (1331 floats) and the peak list (strict peaks are never
// adjacent: at most 5^3 of the 9^3 interior bins) reuse the factor stage
static_assert(125 <= kChunk * kPad &&
                  sift3d::kPatchVox <= (sift3d::kPatchDim + 1) * (kChunk + 1),
              "the peak plane and list fit in the factor stage");

enum Mode { kSplat, kPeaks, kTopk };  // where the body stops

// Where a row's V points come from: row c of the [C, V] arrays in device
// memory (K3, K8, K9), or the fused canonical kernels' points in shared
// memory. coord(a, v) is point v's bin coordinate on axis a (0 = x, 1 = y,
// 2 = z), weight(v) its weight.
struct RowPoints {
  const float* __restrict__ cx;
  const float* __restrict__ cy;
  const float* __restrict__ cz;
  const float* __restrict__ w;
  size_t row;  // c * V
  __device__ __forceinline__ float coord(int a, int v) const {
    return (a == 0 ? cx : (a == 1 ? cy : cz))[row + v];
  }
  __device__ __forceinline__ float weight(int v) const { return w[row + v]; }
};

struct SharedPoints {
  const float (*p)[sift3d::kSphereV];  // [4][V]: x, y, z, weight
  __device__ __forceinline__ float coord(int a, int v) const { return p[a][v]; }
  __device__ __forceinline__ float weight(int v) const { return p[3][v]; }
};

// kSplat writes the histogram to hist_out; kPeaks writes it and the peak
// plane to hist_out / pk_out (each [C, 1331]); kTopk writes out [C, k, 16].
// c: the row's index in the outputs; band: [11, 11], in device or shared
// memory.
template <int M, class Points>
__device__ __forceinline__ void hist_body(const Points pts, const float* __restrict__ band,
                                          float* __restrict__ hist_out,
                                          float* __restrict__ pk_out,
                                          float* __restrict__ out, int c, int V, int k) {
  using namespace sift3d;
  constexpr int P = kPatchDim;
  constexpr int PP = P * P;
  __shared__ float band_s[PP];
  // fx and fy point-fastest with a 129-float row stride (staging stores and
  // the splat's per-thread reads hit distinct banks); row 11 stays zero for
  // the padding threads. fz (z weighted) point-major, three float4 a point.
  __shared__ float fxy[2][P + 1][kChunk + 1];
  __shared__ __align__(16) float fz_s[kChunk][kPad];
  // per point: its nonzero y factors lo | hi << 8, kSkip when its weighted
  // z factors are all zero
  __shared__ int meta[kChunk];
  __shared__ int live_s[kThreads / 32][kChunk];  // per warp: the points it adds
  __shared__ float hist[kPatchVox];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < PP; i += kThreads) band_s[i] = band[i];
  for (int i = tid; i < 2 * (kChunk + 1); i += kThreads) fxy[i / (kChunk + 1)][P][i % (kChunk + 1)] = 0.0f;

  // this thread's column; threads 121..127 read the zero row (y = 11)
  const int y = tid / P, x = tid % P;
  // the y rows of this warp's columns
  const int wy_lo = (warp * 32) / P, wy_hi = min(P - 1, (warp * 32 + 31) / P);

  float acc[P];
#pragma unroll
  for (int z = 0; z < P; ++z) acc[z] = 0.0f;

  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();  // band_s ready / previous chunk consumed
    if (tid < nv) {  // thread v stages point v: its three factor rows
      const int v = tid;
      const float wv = pts.weight(v0 + v);
      int y_lo = P, y_hi = -1;
      bool z_any = false, finite = true;
      float fz[kPad];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        int i0;
        float w0;
        interp_bin(pts.coord(a, v0 + v), P, i0, w0);
        const float w1 = 1.0f - w0;
#pragma unroll
        for (int o = 0; o < P; ++o) {
          const float val = w0 * band_s[i0 * P + o] + w1 * band_s[(i0 + 1) * P + o];
          const float fo = a == 2 ? wv * val : val;
          if (a < 2) fxy[a][o][v] = fo;
          else fz[o] = fo;
          finite = finite && isfinite(fo);
          if (a == 1 && fo != 0.0f) {
            y_lo = min(y_lo, o);
            y_hi = o;
          }
          z_any = z_any || (a == 2 && fo != 0.0f);
        }
      }
      fz[P] = 0.0f;
      float4* dst = reinterpret_cast<float4*>(fz_s[v]);
      dst[0] = make_float4(fz[0], fz[1], fz[2], fz[3]);
      dst[1] = make_float4(fz[4], fz[5], fz[6], fz[7]);
      dst[2] = make_float4(fz[8], fz[9], fz[10], fz[11]);
      // a point with a non-finite factor is never skipped (0 * inf is NaN)
      if (!finite) {
        y_lo = 0;
        y_hi = P - 1;
        z_any = true;
      }
      meta[v] = z_any && y_lo <= y_hi ? (y_lo | (y_hi << 8)) : kSkip;
    }
    __syncthreads();
    // each warp lists, in index order, the points whose nonzero y factors
    // meet its y rows: the others add exact zeros to every bin it owns
    int n_live = 0;
    for (int base = 0; base < nv; base += 32) {
      const int v = base + lane;
      const int m = v < nv ? meta[v] : kSkip;
      const bool live = (m & 0xff) <= wy_hi && (m >> 8) >= wy_lo;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) live_s[warp][n_live + __popc(mask & ((1u << lane) - 1u))] = v;
      n_live += __popc(mask);
    }
    __syncwarp();
    float s[P];
#pragma unroll
    for (int z = 0; z < P; ++z) s[z] = 0.0f;
    for (int i = 0; i < n_live; ++i) {
      const int v = live_s[warp][i];
      const float p = fxy[1][y][v] * fxy[0][x][v];
      const float4* fz4 = reinterpret_cast<const float4*>(fz_s[v]);
      const float4 a0 = fz4[0], a1 = fz4[1], a2 = fz4[2];
      const float fz[P] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y, a2.z};
#pragma unroll
      for (int z = 0; z < P; ++z) s[z] = fmaf(fz[z], p, s[z]);
    }
#pragma unroll
    for (int z = 0; z < P; ++z) acc[z] = acc[z] + s[z];
  }
  if (tid < PP) {
#pragma unroll
    for (int z = 0; z < P; ++z) {
      hist[z * PP + tid] = acc[z];
      if (M != kTopk) hist_out[(size_t)c * kPatchVox + z * PP + tid] = acc[z];
    }
  }
  if (M == kSplat) return;
  __syncthreads();

  // strict interior 26-neighbour peaks; everything else is -inf. The peak
  // plane reuses the factor stage.
  float* pk = &fxy[0][0][0];
  for (int b = tid; b < kPatchVox; b += kThreads) {
    const int bz = b / PP, by = (b / P) % P, bx = b % P;
    float pv = -INFINITY;
    if (bz >= 1 && bz <= P - 2 && by >= 1 && by <= P - 2 && bx >= 1 && bx <= P - 2) {
      const float h = hist[b];
      bool peak = true;
      for (int dz = -1; dz <= 1; ++dz)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            if (dz == 0 && dy == 0 && dx == 0) continue;
            peak = peak && (h > hist[b + (dz * P + dy) * P + dx]);
          }
      if (peak) pv = h;
    }
    pk[b] = pv;
    if (M == kPeaks) pk_out[(size_t)c * kPatchVox + b] = pv;
  }
  if (M == kPeaks) return;
  __syncthreads();
  if (warp != 0) return;

  // warp 0: the peaks in ascending flat index, then k rounds of arg-max
  // (lowest flat index first among equal values)
  float* list_v = &fxy[1][0][0];
  int* list_i = reinterpret_cast<int*>(&fz_s[0][0]);
  int n = 0;
  for (int base = 0; base < kPatchVox; base += 32) {
    const int b = base + lane;
    const bool is_pk = b < kPatchVox && pk[b] > -INFINITY;
    const unsigned m = __ballot_sync(0xffffffffu, is_pk);
    if (is_pk) {
      const int at = n + __popc(m & ((1u << lane) - 1u));
      list_v[at] = pk[b];
      list_i[at] = b;
    }
    n += __popc(m);
  }
  __syncwarp();
  for (int s = 0; s < k; ++s) {
    float bv = -INFINITY;
    int bi = kPatchVox, bj = -1;
    for (int j = lane; j < n; j += 32) {  // ascending flat index within a lane
      if (list_v[j] > bv) {
        bv = list_v[j];
        bi = list_i[j];
        bj = j;
      }
    }
    float gv = bv;
    int gi = bi;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, gv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, gi, off);
      if (ov > gv || (ov == gv && oi < gi)) {
        gv = ov;
        gi = oi;
      }
    }
    const bool valid = gv > -INFINITY;
    int z = 1, yy = 1, xx = 1;
    if (valid) {
      z = gi / PP;
      yy = (gi / P) % P;
      xx = gi % P;
    }
    const int b = (z * P + yy) * P + xx;
    float* o = out + ((size_t)c * k + s) * kLanes;
    if (lane < kLanes) {
      float val = 0.0f;
      switch (lane) {
        case 0: val = gv; break;
        case 1: val = hist[b - 1]; break;
        case 2: val = hist[b + 1]; break;
        case 3: val = hist[b - P]; break;
        case 4: val = hist[b + P]; break;
        case 5: val = hist[b - PP]; break;
        case 6: val = hist[b + PP]; break;
        case 7: val = (float)((z * P + yy) * kLanes + xx); break;
        default: break;
      }
      o[lane] = val;
    }
    if (valid && bj >= 0 && bi == gi) list_v[bj] = -INFINITY;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
hist_topk_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                 const float* __restrict__ cz, const float* __restrict__ w,
                 const float* __restrict__ band, float* __restrict__ out, int V, int k) {
  hist_body<kTopk>(RowPoints{cx, cy, cz, w, (size_t)blockIdx.x * V}, band, nullptr, nullptr, out,
                   blockIdx.x, V, k);
}

__global__ void __launch_bounds__(kThreads)
splat_histogram_raw_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                           const float* __restrict__ cz, const float* __restrict__ w,
                           const float* __restrict__ band, float* __restrict__ hist, int V) {
  hist_body<kSplat>(RowPoints{cx, cy, cz, w, (size_t)blockIdx.x * V}, band, hist, nullptr, nullptr,
                    blockIdx.x, V, 0);
}

__global__ void __launch_bounds__(kThreads)
smooth_histogram_peaks_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                              const float* __restrict__ cz, const float* __restrict__ w,
                              const float* __restrict__ band, float* __restrict__ hist,
                              float* __restrict__ pk, int V) {
  hist_body<kPeaks>(RowPoints{cx, cy, cz, w, (size_t)blockIdx.x * V}, band, hist, pk, nullptr,
                    blockIdx.x, V, 0);
}

// ---- the fused canonical stage: features.canonical_stage_plain ----

constexpr int kMaxSlots = sift3d::kPatchVox / kLanes;  // 83: the top-k rows reuse the patch's stage

// The orientation histograms' blur band, passed by value (no copy to the
// device).
struct Band {
  float v[sift3d::kPatchDim * sift3d::kPatchDim];
};

// What both launches share: the row's patch (then its top-k rows), its
// in-sphere voxels in ascending flat index (np.nonzero(sphere_mask().ravel())),
// the points' bin coordinates and weights, and the band.
struct CanonicalStage {
  float p[sift3d::kPatchVox];
  float pts[4][sift3d::kSphereV];
  short sphere[sift3d::kSphereV];
  float band[sift3d::kPatchDim * sift3d::kPatchDim];
};

// Load row c's patch and list the in-sphere voxels (warp 0); ends with a
// barrier.
__device__ __forceinline__ void load_row(CanonicalStage& st, const float* __restrict__ pn, size_t c) {
  using namespace sift3d;
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < kPatchVox; i += kThreads) st.p[i] = pn[c * kPatchVox + i];
  if (tid < 32) {
    int n = 0;
    for (int base = 0; base < kPatchVox; base += 32) {
      const int b = base + lane;
      const bool in = b < kPatchVox && in_sphere(b);
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) st.sphere[n + __popc(m & ((1u << lane) - 1u))] = (short)b;
      n += __popc(m);
    }
  }
  __syncthreads();
}

// sphere_edges at voxel i: the unit gradient direction e (x, y, z) and the
// weight, its magnitude (0 where not > 0).
__device__ __forceinline__ void sphere_edge(const float* p, int i, float (&e)[3], float& w) {
  float g[3];
  sift3d::patch_gradient(p, i, g[0], g[1], g[2]);
  const float mag = sqrtf(fmaf(g[2], g[2], fmaf(g[1], g[1], g[0] * g[0])));
  w = mag > 0.0f ? mag : 0.0f;
  const float d = mag > 0.0f ? mag : 1.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) e[a] = g[a] / d;
}

// features._fdot3(a, b): fma(a_z, b_z, fma(a_y, b_y, a_x * b_x)).
__device__ __forceinline__ float fdot3(const float (&a)[3], const float (&b)[3]) {
  return fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0]));
}

// features._norm_or_x in place: v / sqrt(v . v), (1, 0, 0) where v . v is
// not > 0.
__device__ __forceinline__ void norm_or_x(float (&v)[3]) {
  const float ss = fdot3(v, v);
  const float n = sqrtf(ss > 0.0f ? ss : 1.0f);
#pragma unroll
  for (int a = 0; a < 3; ++a) v[a] = ss > 0.0f ? v[a] / n : (a == 0 ? 1.0f : 0.0f);
}

// features.hist_tops on one top-k row o[16]: the peak's quadratic vertex on
// each axis, less rad (features.canonical_stage_plain's itp - rad).
__device__ __forceinline__ void peak_vertex(const float* o, float (&d)[3]) {
  using namespace sift3d;
  const int flat = (int)o[7];
  const int pp = flat / kLanes;
  const int pc[3] = {flat % kLanes, pp % kPatchDim, pp / kPatchDim};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float cf = (float)pc[a];
    d[a] = quadratic_interp(o[1 + 2 * a], o[0], o[2 + 2 * a], cf - 1.0f, cf, cf + 1.0f) - (float)kPatchRad;
  }
}

// Top-k slot s of a row's histogram is a peak at or above thr times the
// strongest (strict < breaks, MultiScale.cpp:2889) and above 0.
__device__ __forceinline__ bool live_peak(const float* tops, int s, float thr) {
  const float v = tops[s * kLanes];
  return isfinite(v) && v >= thr * tops[0] && v > 0.0f;
}

// Launch A, one block per row c: the primary histogram over the row's
// in-sphere unit gradients, its top K1 peaks, the 0.8 threshold and
// _norm_or_x of each vertex: p1 [C, K1, 3] and live [C, K1] (valid1 &
// kvalid) for launch B.
__global__ void __launch_bounds__(kThreads)
canonical_primary_kernel(const float* __restrict__ pn, const bool* __restrict__ kvalid, const Band band,
                         float* __restrict__ p1, bool* __restrict__ live, float thr, int K1) {
  using namespace sift3d;
  __shared__ CanonicalStage st;
  const size_t c = blockIdx.x;
  const int tid = threadIdx.x;
  if (kvalid != nullptr && !kvalid[c]) {  // the whole block: no secondaries for a dead row
    for (int s = tid; s < K1; s += kThreads) live[c * K1 + s] = false;
    return;
  }
  for (int i = tid; i < kPatchDim * kPatchDim; i += kThreads) st.band[i] = band.v[i];
  load_row(st, pn, c);
  for (int j = tid; j < kSphereV; j += kThreads) {
    float e[3];
    sphere_edge(st.p, st.sphere[j], e, st.pts[3][j]);
#pragma unroll
    for (int a = 0; a < 3; ++a) st.pts[a][j] = e[a] * (float)kPatchRad + (float)kPatchRad;
  }
  hist_body<kTopk>(SharedPoints{st.pts}, st.band, nullptr, nullptr, st.p, 0, kSphereV, K1);
  __syncthreads();
  if (tid < K1) {
    float d[3];
    peak_vertex(st.p + tid * kLanes, d);
    norm_or_x(d);
#pragma unroll
    for (int a = 0; a < 3; ++a) p1[(c * K1 + tid) * 3 + a] = d[a];
    live[c * K1 + tid] = live_peak(st.p, tid, thr);
  }
}

// Launch B, one block per (row, primary) slot: a dead slot writes zero
// frames and no valid secondary; a live one splats the row's unit
// gradients projected perpendicular to its primary p1 (the (1, 0, 0)
// fallback where the projection vanishes), takes the top K2 peaks and the
// 0.5 threshold, orthogonalizes each vertex against p1, renormalizes and
// writes the frames [p1; p2; p1 x p2] of all K2 secondaries, invalid ones
// included (canonical_stage_plain's ori[sidx] = orir).
__global__ void __launch_bounds__(kThreads)
canonical_secondary_kernel(const float* __restrict__ pn, const Band band, const float* __restrict__ p1,
                           const bool* __restrict__ live, float* __restrict__ ori,
                           bool* __restrict__ ori_valid, float thr, int K1, int K2) {
  using namespace sift3d;
  __shared__ CanonicalStage st;
  const size_t slot = blockIdx.x;
  const int tid = threadIdx.x;
  float* frames = ori + slot * K2 * 9;
  if (!live[slot]) {
    for (int i = tid; i < K2 * 9; i += kThreads) frames[i] = 0.0f;
    for (int s = tid; s < K2; s += kThreads) ori_valid[slot * K2 + s] = false;
    return;
  }
  const float q1[3] = {p1[slot * 3], p1[slot * 3 + 1], p1[slot * 3 + 2]};
  for (int i = tid; i < kPatchDim * kPatchDim; i += kThreads) st.band[i] = band.v[i];
  load_row(st, pn, slot / K1);
  for (int j = tid; j < kSphereV; j += kThreads) {
    float e[3];
    sphere_edge(st.p, st.sphere[j], e, st.pts[3][j]);
    const float par = fdot3(e, q1);
#pragma unroll
    for (int a = 0; a < 3; ++a) e[a] = fmaf(-par, q1[a], e[a]);
    norm_or_x(e);
#pragma unroll
    for (int a = 0; a < 3; ++a) st.pts[a][j] = e[a] * (float)kPatchRad + (float)kPatchRad;
  }
  hist_body<kTopk>(SharedPoints{st.pts}, st.band, nullptr, nullptr, st.p, 0, kSphereV, K2);
  __syncthreads();
  if (tid < K2) {
    float d[3];
    peak_vertex(st.p + tid * kLanes, d);
    norm_or_x(d);
    const float par = fdot3(d, q1);
    float q2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) q2[a] = fmaf(-par, q1[a], d[a]);
    norm_or_x(q2);
    // features._fcross3(p1, p2): each a_i b_j - a_j b_i with the first product fused
    const float q3[3] = {fmaf(q1[1], q2[2], -(q1[2] * q2[1])), fmaf(q1[2], q2[0], -(q1[0] * q2[2])),
                         fmaf(q1[0], q2[1], -(q1[1] * q2[0]))};
    float* f = frames + tid * 9;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      f[a] = q1[a];
      f[3 + a] = q2[a];
      f[6 + a] = q3[a];
    }
    ori_valid[slot * K2 + tid] = live_peak(st.p, tid, thr);
  }
}

}  // namespace

extern "C" int sift3d_hist_topk(const float* cx, const float* cy, const float* cz,
                                const float* w, const float* band, float* out, int C, int V,
                                int k, int device, void* stream) {
  SIFT3D_LAUNCH(device, hist_topk_kernel, dim3(C), dim3(kThreads), stream, cx, cy, cz, w, band,
                out, V, k);
}

extern "C" int sift3d_splat_histogram_raw(const float* cx, const float* cy, const float* cz,
                                          const float* w, const float* band, float* hist, int C,
                                          int V, int device, void* stream) {
  SIFT3D_LAUNCH(device, splat_histogram_raw_kernel, dim3(C), dim3(kThreads), stream, cx, cy, cz,
                w, band, hist, V);
}

extern "C" int sift3d_smooth_histogram_peaks(const float* cx, const float* cy, const float* cz,
                                             const float* w, const float* band, float* hist,
                                             float* pk, int C, int V, int device, void* stream) {
  SIFT3D_LAUNCH(device, smooth_histogram_peaks_kernel, dim3(C), dim3(kThreads), stream, cx, cy,
                cz, w, band, hist, pk, V);
}

// band: [11, 11] in host memory; kvalid: [C] or null; p1 [C, K1, 3] and
// live [C, K1]: scratch between the two launches; out ori [C, K1, K2, 3, 3],
// ori_valid [C, K1, K2]. K1, K2 in [1, 83].
extern "C" int sift3d_canonical(const float* pn, const bool* kvalid, const float* band, float* p1,
                                bool* live, float* ori, bool* ori_valid, float thr1, float thr2,
                                int C, int K1, int K2, int device, void* stream) {
  if (K1 < 1 || K1 > kMaxSlots || K2 < 1 || K2 > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Band b;
  for (int i = 0; i < sift3d::kPatchDim * sift3d::kPatchDim; ++i) b.v[i] = band[i];
  const cudaStream_t s = (cudaStream_t)stream;
  canonical_primary_kernel<<<C, kThreads, 0, s>>>(pn, kvalid, b, p1, live, thr1, K1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  canonical_secondary_kernel<<<C * K1, kThreads, 0, s>>>(pn, b, p1, live, ori, ori_valid, thr2, K1, K2);
  return (int)cudaGetLastError();
}
