// M3: Hough similarity voting over a stack of image pairs, every hypothesis
// scored against every match of its own pair as an integer inlier count,
// and the winners' inlier masks.
//
// Replaces the XLA program of sift3d/match/hough.py: _hough_scores (the
// hypotheses' triangle frames, rotations and scales, and the
// hypotheses-by-matches compare, mapped over 128-hypothesis chunks on a
// power-of-two padded M) and _hough_inliers (the winner's mask).
// Not a Pallas kernel in the JAX package. The matches of P pairs are
// concatenated, pair p holding matches offsets[p] .. offsets[p + 1] - 1.
// Match h is hypothesis h: the pair (p0_h, p1_h), and the rotation R_h
// (row-major) and scale s_h that form_hypothesis() builds in registers
// from the match's own ori rows and scales in the order of
// hough.hypotheses: the triangle frames of o0_h and o1_h (each edge and
// cross product normalized by the correctly rounded root of its fma-chained
// sum of squares, a zero norm dividing by 1; each cross term fma(a_i, b_j,
// -(a_j b_i))), R_h = R1^T R0 as fma-chained dots, and s_h the ratio of the
// triangles' perimeters, the first floored at 1e-20. __fmaf_rn is
// numerics.fma_exact, __fsqrt_rn numerics.sqrt and __fdiv_rn torch's f32
// division, so the hypotheses are the host's bit for bit (but a NaN's
// payload) and no rotation or scale table is read. Match j of the same
// pair is an inlier of h when all of
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
// pair, each formed by its thread (once a block, so ceil(M_p / 128) times
// over a pair's match chunks), against one chunk of 128 of its matches,
// staged in shared memory (26 floats a match, read as broadcasts), and adds
// its count to each hypothesis's score with an integer atomic, which is
// exact in any order. Inliers: a block takes 128 matches of one pair, one a
// thread, against the pair's winning hypothesis, formed once a block into
// shared memory, and writes the mask; so the mask and the count come from
// the same predicate and cannot disagree. The first block of each pair
// writes the winner's rotation and scale, which the caller reads back in
// the same copy as the mask.
//
// What bounds it on an H100: launches and the tail, not arithmetic. f32
// operations are about 34 a pair, 60 more for the pairs past the distance
// test and 4 for those past the orientation test (31 pairs of 1000
// matches: about 1 GFLOP, 0.016 ms at 67 TFLOP/s), and about 170 a
// hypothesis formed (14 of them roots, 25 divisions), once a block; the f64
// log runs only for pairs that pass the other two tests; the inputs are 26
// floats a match. One pair's grid is small (M = 1000: 64 blocks for 132 SMs), so
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

// hough._dot3_fma: fma(a2, b2, fma(a1, b1, a0 b0)), a and b strided
__device__ __forceinline__ float dot3_fma(const float* a, int sa, const float* b, int sb) {
  return __fmaf_rn(a[2 * sa], b[2 * sb], __fmaf_rn(a[sa], b[sb], __fmul_rn(a[0], b[0])));
}

// hough._normalize: v / n, n the correctly rounded root of v . v, 1 where
// n > 0 fails (zero or NaN)
__device__ __forceinline__ void normalize(float* v) {
  const float n = __fsqrt_rn(dot3_fma(v, 1, v, 1));
  const float d = n > 0.0f ? n : 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __fdiv_rn(v[c], d);
}

// hough._cross: term (i, j) = fma(a_i, b_j, -(a_j b_i))
__device__ __forceinline__ void cross(const float* a, const float* b, float* c) {
  c[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// hough.triangle_frame of the ori rows o (row-major 3x3): the rows v12,
// third, n into f (row-major)
__device__ __forceinline__ void triangle_frame(const float* o, float* f) {
  float* v12 = f;
  float* third = f + 3;
  float* n = f + 6;
  float v13[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v12[c] = __fsub_rn(o[3 + c], o[c]);
    v13[c] = __fsub_rn(o[6 + c], o[c]);
  }
  normalize(v12);
  normalize(v13);
  cross(v12, v13, n);
  normalize(n);
  cross(n, v12, third);
  normalize(third);
}

// hough.triangle_perimeter: s ((|P0 - P1| + |P0 - P2|) + |P1 - P2|) of the
// ori rows o
__device__ __forceinline__ float triangle_perimeter(const float* o, float s) {
  float d[3];
  const int ends[3][2] = {{0, 1}, {0, 2}, {1, 2}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) e[c] = __fsub_rn(o[3 * ends[k][0] + c], o[3 * ends[k][1] + c]);
    d[k] = __fsqrt_rn(dot3_fma(e, 1, e, 1));
  }
  return __fmul_rn(s, __fadd_rn(__fadd_rn(d[0], d[1]), d[2]));
}

// Match h as a hypothesis (hough.hypotheses): rot = R1^T R0 of the two
// triangle frames, scale = the perimeters' ratio, and the pair.
__device__ __forceinline__ Hypothesis form_hypothesis(const float* __restrict__ p0, const float* __restrict__ p1,
                                                      const float* __restrict__ s0, const float* __restrict__ s1,
                                                      const float* __restrict__ o0, const float* __restrict__ o1,
                                                      int h) {
  float a[9], b[9], r0[9], r1[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    a[c] = o0[9 * h + c];
    b[c] = o1[9 * h + c];
  }
  triangle_frame(a, r0);
  triangle_frame(b, r1);
  Hypothesis y;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) y.R[3 * i + j] = dot3_fma(r1 + i, 3, r0 + j, 3);  // column i of r1 . column j of r0
  }
  const float q0 = triangle_perimeter(a, s0[h]);
  y.s = __fdiv_rn(triangle_perimeter(b, s1[h]), sift3d::nan_max(q0, 1e-20f));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    y.a[c] = p0[3 * h + c];
    y.b[c] = p1[3 * h + c];
  }
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
hough_kernel(int mode, const float* __restrict__ p0, const float* __restrict__ p1, const float* __restrict__ s0,
             const float* __restrict__ s1, const float* __restrict__ o0, const float* __restrict__ o1,
             const int* __restrict__ offsets, const int* __restrict__ block_offsets, const int* __restrict__ winners,
             int* __restrict__ scores, unsigned char* __restrict__ mask, float* __restrict__ winner_rs, int P,
             int M, int winner, float thres_scale, float thres_trans, float thres_orien) {
  __shared__ float mt[kChunk * kW];
  __shared__ Hypothesis won;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  int pair = 0, base = 0, m = M, local = b;
  if (offsets != nullptr) {
    // the pair: the last p with block_offsets[p] <= b (pairs without blocks
    // share their offset with the next pair)
    int lo = 0, hi = P;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (block_offsets[mid] <= b) lo = mid;
      else hi = mid;
    }
    pair = lo;
    base = offsets[lo];
    m = offsets[lo + 1] - base;
    local = b - block_offsets[lo];
    if (mode == kInliers) winner = winners[lo];
  }

  if (mode == kInliers) {
    if (tid == 0) {
      won = form_hypothesis(p0, p1, s0, s1, o0, o1, winner);
      if (local == 0) {
#pragma unroll
        for (int c = 0; c < 9; ++c) winner_rs[10 * pair + c] = won.R[c];
        winner_rs[10 * pair + 9] = won.s;
      }
    }
    __syncthreads();
    const int j = local * kThreads + tid;
    if (j >= m) return;
    float rec[kW];
    load_match(p0, p1, s0, s1, o0, o1, base + j, rec);
    mask[base + j] = inlier(won, rec, thres_scale, thres_trans, thres_orien) ? 1 : 0;
    return;
  }

  const int nchunks = (m + kChunk - 1) / kChunk;
  const int h = (local / nchunks) * kThreads + tid;
  const int j0 = (local % nchunks) * kChunk;
  const int nj = min(kChunk, m - j0);
  for (int e = tid; e < nj; e += kThreads) load_match(p0, p1, s0, s1, o0, o1, base + j0 + e, mt + e * kW);
  __syncthreads();
  if (h >= m) return;
  const Hypothesis y = form_hypothesis(p0, p1, s0, s1, o0, o1, base + h);
  int count = 0;
  for (int e = 0; e < nj; ++e) count += inlier(y, mt + e * kW, thres_scale, thres_trans, thres_orien) ? 1 : 0;
  if (count) atomicAdd(scores + base + h, count);
}

}  // namespace

// p0 [M, 3], p1 [M, 3], s0 [M], s1 [M], o0 [M, 9], o1 [M, 9] f32, the P
// pairs' matches concatenated, each match also its hypothesis (formed in
// the kernel); offsets [P + 1] and block_offsets [P + 1] int32
// (hough.segment_blocks for this mode; blocks = block_offsets[P] > 0), or
// both null for one pair of M matches (P = 1: no table to copy to the
// card). mode 0: scores [M] int32, zeroed by the caller. mode 1: each
// pair's winning hypothesis, a row of the stack: winners [P] int32, or
// with offsets null the argument winner; mask [M] bytes (0 or 1) and
// winner_rs [P, 10] f32, each pair with matches its winner's rotation
// (row-major) and scale (a pair without matches is left as it was). The
// thresholds rounded to f32.
extern "C" int sift3d_hough(int mode, const float* p0, const float* p1, const float* s0, const float* s1,
                            const float* o0, const float* o1, const int* offsets, const int* block_offsets,
                            const int* winners, int* scores, unsigned char* mask, float* winner_rs, int P, int M,
                            int winner, int blocks, float thres_scale, float thres_trans, float thres_orien,
                            int device, void* stream) {
  if ((mode != kScores && mode != kInliers) || P < 1 || blocks < 1 || (offsets == nullptr && P != 1))
    return (int)cudaErrorInvalidValue;
  SIFT3D_LAUNCH(device, hough_kernel, dim3(blocks), dim3(kThreads), stream, mode, p0, p1, s0, s1, o0, o1,
                offsets, block_offsets, winners, scores, mask, winner_rs, P, M, winner, thres_scale, thres_trans,
                thres_orien);
}
