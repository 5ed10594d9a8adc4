// M3: Hough similarity voting, every hypothesis scored against every match
// as an integer inlier count.
//
// Replaces the XLA program of sift3d/match/hough.py: _hough_scores (the
// hypotheses-by-matches compare, mapped over 128-hypothesis chunks on a
// power-of-two padded M). Not a Pallas kernel in the JAX package. Match h
// is hypothesis h: rotation R_h (row-major), scale s_h and the pair
// (p0_h, p1_h). Match j is an inlier of h when all of
//   |xyz1_j - (R_h (xyz0_j - p0_h) * s_h + p1_h)| < thres_trans * s1_j,
//   thres_orien < min_k (R_h o0_j[k]) . o1_j[k]   (the rows k of o0, o1),
//   |log(s1_j / max(s0_j * s_h, 1e-20))| < thres_scale
// hold; the score is their count (JAX sums prob, which the matcher sets to
// ones, so its f32 score is this count). Every dot product is
// ((a0 b0 + a1 b1) + a2 b2), the norm the correctly rounded root of such a
// sum, the log computed in f64 and rounded to f32, min NaN-propagating:
// the order of hough.hough_ok, the plain version.
//
// What bounds it on an H100: f32 operations, about 80 a pair (M = 3000:
// 9 M pairs, 0.7 GFLOP, 0.011 ms at 67 TFLOP/s); the inputs are 26 floats a
// match. The f64 log runs only for pairs that pass the other two tests.
//
// Design: one hypothesis a thread, its rotation, scale and pair in
// registers; a block of 128 hypotheses walks one chunk of 256 matches,
// staged in shared memory (26 floats a match, read as broadcasts), so
// M = 1500 runs as 12 x 6 blocks. Each block adds its chunk's count to the
// hypothesis's score with an integer atomic, which is exact in any order.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // hypotheses per block
constexpr int kChunk = 256;    // matches per block
constexpr int kW = 26;         // floats a match: p0 3, p1 3, s0, s1, o0 9, o1 9

__global__ void __launch_bounds__(kThreads)
hough_scores_kernel(const float* __restrict__ rots, const float* __restrict__ hscale,
                    const float* __restrict__ p0, const float* __restrict__ p1,
                    const float* __restrict__ s0, const float* __restrict__ s1,
                    const float* __restrict__ o0, const float* __restrict__ o1, int* __restrict__ scores,
                    int M, float thres_scale, float thres_trans, float thres_orien) {
  __shared__ float mt[kChunk * kW];
  const int tid = threadIdx.x;
  const int h = blockIdx.x * kThreads + tid;
  const int j0 = blockIdx.y * kChunk;
  const int nj = min(kChunk, M - j0);
  for (int e = tid; e < nj; e += kThreads) {
    float* m = mt + e * kW;
    const int j = j0 + e;
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
  __syncthreads();
  if (h >= M) return;
  float R[9], a[3], b[3];
#pragma unroll
  for (int c = 0; c < 9; ++c) R[c] = rots[9 * h + c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = p0[3 * h + c];
    b[c] = p1[3 * h + c];
  }
  const float sh = hscale[h];
  int count = 0;
  for (int e = 0; e < nj; ++e) {
    const float* m = mt + e * kW;
    const float d0 = m[0] - a[0], d1 = m[1] - a[1], d2 = m[2] - a[2];
    float r2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float proj = ((R[3 * i] * d0 + R[3 * i + 1] * d1) + R[3 * i + 2] * d2) * sh + b[i];
      const float ei = m[3 + i] - proj;
      r2 = i == 0 ? ei * ei : r2 + ei * ei;
    }
    if (!(sqrtf(r2) < thres_trans * m[7])) continue;
    float mincos = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* u = m + 8 + 3 * k;   // row k of o0
      const float* w = m + 17 + 3 * k;  // row k of o1
      float cs = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float ro = (R[3 * i] * u[0] + R[3 * i + 1] * u[1]) + R[3 * i + 2] * u[2];
        cs = i == 0 ? ro * w[0] : cs + ro * w[i];
      }
      mincos = k == 0 ? cs : sift3d::nan_min(mincos, cs);
    }
    if (!(thres_orien < mincos)) continue;
    const float ratio = m[7] / sift3d::nan_max(m[6] * sh, 1e-20f);
    if (fabsf((float)log((double)ratio)) < thres_scale) ++count;
  }
  if (count) atomicAdd(scores + h, count);
}

}  // namespace

// rots [M, 9], hscale [M], p0 [M, 3], p1 [M, 3], s0 [M], s1 [M], o0 [M, 9],
// o1 [M, 9] f32; scores [M] int32, zeroed by the caller; the thresholds
// rounded to f32.
extern "C" int sift3d_hough_scores(const float* rots, const float* hscale, const float* p0, const float* p1,
                                   const float* s0, const float* s1, const float* o0, const float* o1,
                                   int* scores, int M, float thres_scale, float thres_trans,
                                   float thres_orien, int device, void* stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, (M + kChunk - 1) / kChunk);
  SIFT3D_LAUNCH(device, hough_scores_kernel, grid, dim3(kThreads), stream, rots, hscale, p0, p1, s0, s1, o0,
                o1, scores, M, thres_scale, thres_trans, thres_orien);
}
