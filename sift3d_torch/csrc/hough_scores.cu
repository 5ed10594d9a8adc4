// M3: Hough similarity voting over a stack of image pairs, every hypothesis
// scored against every match of its own pair as an integer inlier count,
// and the winners' inlier masks.
//
// Replaces the XLA program of sift3d/match/hough.py: _hough_scores (the
// hypotheses-by-matches compare, mapped over 128-hypothesis chunks on a
// power-of-two padded M) and _hough_inliers (the winner's mask).
// Not a Pallas kernel in the JAX package. The matches of P pairs are
// concatenated, pair p holding matches offsets[p] .. offsets[p + 1] - 1.
// Match h is hypothesis h: rotation R_h (row-major), scale s_h and the
// pair (p0_h, p1_h). Match j of the same pair is an inlier of h when all of
//   |xyz1_j - (R_h (xyz0_j - p0_h) * s_h + p1_h)| < thres_trans * s1_j,
//   thres_orien < min_k (R_h o0_j[k]) . o1_j[k]   (the rows k of o0, o1),
//   |log(s1_j / max(s0_j * s_h, 1e-20))| < thres_scale
// hold (inlier(), the one predicate of both modes); the score is their
// count (JAX sums prob, which the matcher sets to ones, so its f32 score is
// this count). Every dot product is ((a0 b0 + a1 b1) + a2 b2), the norm the
// correctly rounded root of such a sum, the log computed in f64 and
// rounded to f32, min NaN-propagating: the order of hough.hough_ok, the
// plain version.
//
// Two modes of one kernel. Scores: a block takes 128 hypotheses of one
// pair against one chunk of 128 of its matches, staged in shared memory
// (26 floats a match, read as broadcasts), and adds its count to each
// hypothesis's score with an integer atomic, which is exact in any order.
// Inliers: a block takes 128 matches of one pair, one a thread, against the
// pair's winning hypothesis, and writes the mask; so the mask and the count
// come from the same predicate and cannot disagree.
//
// What bounds it on an H100: launches and the tail, not arithmetic. f32
// operations are about 34 a pair, 60 more for the pairs past the distance
// test and 4 for those past the orientation test (31 pairs of 1000
// matches: about 1 GFLOP, 0.016 ms at 67 TFLOP/s); the f64 log runs only
// for pairs that pass the other two tests; the inputs are 36 floats a
// match. One pair's grid is small (M = 1000: 64 blocks for 132 SMs), so
// the grid covers every (pair, hypothesis tile, match chunk) of the stack
// in one launch: block b finds its pair by a binary search of
// block_offsets (hough.segment_blocks: ceil(M_p / 128)^2 blocks a pair for
// the scores, ceil(M_p / 128) for the masks), 31 pairs of 1000 matches give
// 1984 blocks of 128 threads, 15 a SM. A single pair (match_keys, one
// hough_similarity) passes its match count and winner as arguments and no
// table, so its call copies nothing to the card but the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // hypotheses (scores) or matches (inliers) per block: hough.HOUGH_THREADS
constexpr int kChunk = 128;    // matches per scores block: hough.HOUGH_CHUNK
constexpr int kW = 26;         // floats a match: p0 3, p1 3, s0, s1, o0 9, o1 9
constexpr int kScores = 0, kInliers = 1;

__device__ __forceinline__ void load_match(const float* __restrict__ p0, const float* __restrict__ p1,
                                           const float* __restrict__ s0, const float* __restrict__ s1,
                                           const float* __restrict__ o0, const float* __restrict__ o1, int j,
                                           float* m) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[c] = p0[3 * j + c];
    m[3 + c] = p1[3 * j + c];
  }
  m[6] = s0[j];
  m[7] = s1[j];
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    m[8 + c] = o0[9 * j + c];
    m[17 + c] = o1[9 * j + c];
  }
}

struct Hypothesis {
  float R[9], a[3], b[3], s;
};

__device__ __forceinline__ Hypothesis load_hypothesis(const float* __restrict__ rots,
                                                      const float* __restrict__ hscale,
                                                      const float* __restrict__ p0, const float* __restrict__ p1,
                                                      int h) {
  Hypothesis y;
#pragma unroll
  for (int c = 0; c < 9; ++c) y.R[c] = rots[9 * h + c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    y.a[c] = p0[3 * h + c];
    y.b[c] = p1[3 * h + c];
  }
  y.s = hscale[h];
  return y;
}

// Is the match m (26 floats) an inlier of hypothesis y?
__device__ __forceinline__ bool inlier(const Hypothesis& y, const float* m, float thres_scale, float thres_trans,
                                       float thres_orien) {
  const float d0 = m[0] - y.a[0], d1 = m[1] - y.a[1], d2 = m[2] - y.a[2];
  float r2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float proj = ((y.R[3 * i] * d0 + y.R[3 * i + 1] * d1) + y.R[3 * i + 2] * d2) * y.s + y.b[i];
    const float ei = m[3 + i] - proj;
    r2 = i == 0 ? ei * ei : r2 + ei * ei;
  }
  if (!(sqrtf(r2) < thres_trans * m[7])) return false;
  float mincos = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* u = m + 8 + 3 * k;   // row k of o0
    const float* w = m + 17 + 3 * k;  // row k of o1
    float cs = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ro = (y.R[3 * i] * u[0] + y.R[3 * i + 1] * u[1]) + y.R[3 * i + 2] * u[2];
      cs = i == 0 ? ro * w[0] : cs + ro * w[i];
    }
    mincos = k == 0 ? cs : sift3d::nan_min(mincos, cs);
  }
  if (!(thres_orien < mincos)) return false;
  const float ratio = m[7] / sift3d::nan_max(m[6] * y.s, 1e-20f);
  return fabsf((float)log((double)ratio)) < thres_scale;
}

__global__ void __launch_bounds__(kThreads)
hough_kernel(int mode, const float* __restrict__ rots, const float* __restrict__ hscale,
             const float* __restrict__ p0, const float* __restrict__ p1, const float* __restrict__ s0,
             const float* __restrict__ s1, const float* __restrict__ o0, const float* __restrict__ o1,
             const int* __restrict__ offsets, const int* __restrict__ block_offsets, const int* __restrict__ winners,
             int* __restrict__ scores, unsigned char* __restrict__ mask, int P, int M, int winner,
             float thres_scale, float thres_trans, float thres_orien) {
  __shared__ float mt[kChunk * kW];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  int base = 0, m = M, local = b;
  if (offsets != nullptr) {
    // the pair: the last p with block_offsets[p] <= b (pairs without blocks
    // share their offset with the next pair)
    int lo = 0, hi = P;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (block_offsets[mid] <= b) lo = mid;
      else hi = mid;
    }
    base = offsets[lo];
    m = offsets[lo + 1] - base;
    local = b - block_offsets[lo];
    if (mode == kInliers) winner = winners[lo];
  }

  if (mode == kInliers) {
    const int j = local * kThreads + tid;
    if (j >= m) return;
    const Hypothesis y = load_hypothesis(rots, hscale, p0, p1, winner);
    float rec[kW];
    load_match(p0, p1, s0, s1, o0, o1, base + j, rec);
    mask[base + j] = inlier(y, rec, thres_scale, thres_trans, thres_orien) ? 1 : 0;
    return;
  }

  const int nchunks = (m + kChunk - 1) / kChunk;
  const int h = (local / nchunks) * kThreads + tid;
  const int j0 = (local % nchunks) * kChunk;
  const int nj = min(kChunk, m - j0);
  for (int e = tid; e < nj; e += kThreads) load_match(p0, p1, s0, s1, o0, o1, base + j0 + e, mt + e * kW);
  __syncthreads();
  if (h >= m) return;
  const Hypothesis y = load_hypothesis(rots, hscale, p0, p1, base + h);
  int count = 0;
  for (int e = 0; e < nj; ++e) count += inlier(y, mt + e * kW, thres_scale, thres_trans, thres_orien) ? 1 : 0;
  if (count) atomicAdd(scores + base + h, count);
}

}  // namespace

// rots [M, 9], hscale [M], p0 [M, 3], p1 [M, 3], s0 [M], s1 [M], o0 [M, 9],
// o1 [M, 9] f32, the P pairs' matches concatenated; offsets [P + 1] and
// block_offsets [P + 1] int32 (hough.segment_blocks for this mode; blocks =
// block_offsets[P] > 0), or both null for one pair of M matches (P = 1: no
// table to copy to the card). mode 0: scores [M] int32, zeroed by the
// caller. mode 1: each pair's winning hypothesis, a row of the stack:
// winners [P] int32, or with offsets null the argument winner; mask [M]
// bytes (0 or 1). The thresholds rounded to f32.
extern "C" int sift3d_hough(int mode, const float* rots, const float* hscale, const float* p0, const float* p1,
                            const float* s0, const float* s1, const float* o0, const float* o1, const int* offsets,
                            const int* block_offsets, const int* winners, int* scores, unsigned char* mask, int P,
                            int M, int winner, int blocks, float thres_scale, float thres_trans, float thres_orien,
                            int device, void* stream) {
  if ((mode != kScores && mode != kInliers) || P < 1 || blocks < 1 || (offsets == nullptr && P != 1))
    return (int)cudaErrorInvalidValue;
  SIFT3D_LAUNCH(device, hough_kernel, dim3(blocks), dim3(kThreads), stream, mode, rots, hscale, p0, p1, s0, s1,
                o0, o1, offsets, block_offsets, winners, scores, mask, P, M, winner, thres_scale, thres_trans,
                thres_orien);
}
