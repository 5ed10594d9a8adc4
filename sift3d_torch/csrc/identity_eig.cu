// Fused K2: refinement, identity 11^3 patch and structure-tensor eigen test,
// one block per candidate row.
//
// Replaces the Pallas kernel sift3d/kernels/patch.py:
// sample_patches_identity_slab (_id_slab_kernel) together with the eager
// code around it in the port: the quadratic refinement and bounds test of
// sift3d_torch.pipeline.features.gather_stage, and the eigen test of
// features.eig_stage (normalize_patches, patch_gradients, the sphere-masked
// structure tensor, sym_eigs_3x3 and the keep rule). Per row, in that order:
//   1. the three axis quadratics and the scale quadratic x2 on the row's DoG
//      level, with quadratic_interp_1d's chain of fused multiply-adds (fmaf,
//      numerics.fma_exact in the plain version), the +0.5 shift and the
//      bounds test;
//   2. the 11^3 identity patch (patch_cuda.sample_identity_plain's
//      arithmetic, common.cuh's identity_tap and trilinear_zyx) into shared
//      memory;
//   3. normalize_patches, both sums in numerics.tree_sum's order; pn out;
//   4-5. gradients from shared memory and the six sphere-masked tensor
//      entries, each a tree_sum;
//   6. sym_eigs_3x3 on one thread, step by step as the plain version (IEEE
//      division, sqrtf, x * x for ** 2, acos and cos through f64);
//   7. the keep rule (MultiScale.cpp:1763).
// -fmad=false keeps every multiply and add separately rounded, so each output
// equals features.gather_eig_plain's bit for bit.
//
// What bounds it on an H100: one thread's eigensolver per row (a few hundred
// dependent f32 operations and two f64 transcendental calls) behind the
// gathers; device bytes are small (the row's voxels, 5.3 KB of pn out). The
// design keeps the patch in shared memory, so the 1331-value raw patch and
// every intermediate of the eager chain (about 800 launches per octave call)
// never reach device memory.
//
// The volume may be a Z slab (the Z-sharded path): the Gaussian slab starts
// at global plane gz0 of an octave `depth` planes deep, the DoG slab at dz0;
// candidate z stays global. Or a batch of B volumes of one shape (batched
// extraction's candidate union): a row's volume index vi picks level
// vi * L + l of the [B, L, Z, Y, X] Gaussian stacks and vi * ND + l of the
// [B, ND, ZD, Y, X] DoGs, and l alone picks the sigmas (size_t offsets: a
// batch passes 2^32 bytes).

#include "common.cuh"

namespace {

using namespace sift3d;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float acos64(float x) { return (float)acos((double)x); }
__device__ __forceinline__ float cos64(float x) { return (float)cos((double)x); }

// kernels/patch.py sym_eigs_3x3 on one symmetric tensor (a00, a01, a02,
// a11, a12, a22): eigenvalues descending, eigenvectors as columns of vec
// (row-major [3][3]).
__device__ void sym_eigs_3x3(const float* a, float* eig, float* vec) {
  const float a00 = a[0], a01 = a[1], a02 = a[2], a11 = a[3], a12 = a[4], a22 = a[5];
  float s = fabsf(a00);
  s = nan_max(s, fabsf(a11));
  s = nan_max(s, fabsf(a22));
  s = nan_max(s, fabsf(a01));
  s = nan_max(s, fabsf(a02));
  s = nan_max(s, fabsf(a12));
  s = clamp_min(s, 1e-30f);
  const float b00 = a00 / s, b11 = a11 / s, b22 = a22 / s;
  const float b01 = a01 / s, b02 = a02 / s, b12 = a12 / s;

  const float q = (b00 + b11 + b22) / 3.0f;
  const float p1 = b01 * b01 + b02 * b02 + b12 * b12;
  const float d0 = b00 - q, d1 = b11 - q, d2 = b22 - q;
  const float p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0f * p1;
  const float p = sqrtf(clamp_min(p2 / 6.0f, 1e-38f));
  const float c00 = d0 / p, c11 = d1 / p, c22 = d2 / p;
  const float c01 = b01 / p, c02 = b02 / p, c12 = b12 / p;
  const float detb = c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02) +
                     c02 * (c01 * c12 - c11 * c02);
  float r = detb / 2.0f;
  r = r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
  const float phi = acos64(r) / 3.0f;
  float e0 = q + 2.0f * p * cos64(phi);                                    // largest
  float e2 = q + 2.0f * p * cos64(phi + (float)(2.0 * 3.14159265358979323846 / 3.0));  // smallest
  float e1 = 3.0f * q - e0 - e2;
  const bool degen = p2 < 1e-30f;  // all eigenvalues equal q
  if (degen) e0 = e1 = e2 = q;

  const float bm[3][3] = {{b00, b01, b02}, {b01, b11, b12}, {b02, b12, b22}};
  const V3 ex = {1.0f, 0.0f, 0.0f};

  // null vector of (b - lam I) from its largest row cross product
  auto null_vec = [&](float lam, V3 fallback) {
    V3 m[3];
    for (int i = 0; i < 3; ++i) {
      m[i] = {bm[i][0] - lam * (i == 0 ? 1.0f : 0.0f), bm[i][1] - lam * (i == 1 ? 1.0f : 0.0f),
              bm[i][2] - lam * (i == 2 ? 1.0f : 0.0f)};
    }
    const V3 c01_ = cross3(m[0], m[1]), c02_ = cross3(m[0], m[2]), c12_ = cross3(m[1], m[2]);
    const float n01 = dot3(c01_, c01_), n02 = dot3(c02_, c02_), n12 = dot3(c12_, c12_);
    const V3 best = pick(n01 >= n02 && n01 >= n12, c01_, pick(n02 >= n12, c02_, c12_));
    const float nb = nan_max(n01, nan_max(n02, n12));
    const bool ok = nb > 1e-24f;
    const float d = sqrtf(ok ? nb : 1.0f);
    const V3 v = {best.x / d, best.y / d, best.z / d};
    return pick(ok, v, fallback);
  };

  // the null vector of (b - lam I) in the plane orthogonal to w: a 2x2
  // symmetric null solve, row-pivoted
  auto middle_vec = [&](V3 w, float lam) {
    const bool use_x = fabsf(w.x) > fabsf(w.y);
    const float inv_xz = 1.0f / sqrtf(clamp_min(w.x * w.x + w.z * w.z, 1e-38f));
    const float inv_yz = 1.0f / sqrtf(clamp_min(w.y * w.y + w.z * w.z, 1e-38f));
    const V3 u = {use_x ? -w.z * inv_xz : 0.0f, use_x ? 0.0f : w.z * inv_yz,
                  use_x ? w.x * inv_xz : -w.y * inv_yz};
    const V3 v = cross3(w, u);
    const V3 r0 = {bm[0][0], bm[0][1], bm[0][2]}, r1 = {bm[1][0], bm[1][1], bm[1][2]},
             r2 = {bm[2][0], bm[2][1], bm[2][2]};
    const V3 bu = {dot3(r0, u), dot3(r1, u), dot3(r2, u)};
    const V3 bv = {dot3(r0, v), dot3(r1, v), dot3(r2, v)};
    const float m00 = dot3(u, bu) - lam;
    const float m01 = dot3(u, bv);
    const float m11 = dot3(v, bv) - lam;
    const bool use_r0 = fabsf(m00) >= fabsf(m11);
    float ca = use_r0 ? m01 : m11;
    float cb = use_r0 ? -m00 : -m01;
    const float n = sqrtf(ca * ca + cb * cb);
    const bool ok = n > 1e-24f;  // both rows ~0: any plane vector works
    const float n_safe = ok ? n : 1.0f;
    ca = ok ? ca / n_safe : 1.0f;
    cb = ok ? cb / n_safe : 0.0f;
    return V3{ca * u.x + cb * v.x, ca * u.y + cb * v.y, ca * u.z + cb * v.z};
  };

  // r >= 0: e1 crowds e2, so e0 is the safely simple extreme; r < 0: e2 is
  const bool simple_hi = r >= 0.0f;
  const V3 w_simple = null_vec(simple_hi ? e0 : e2, ex);
  const V3 v1 = middle_vec(w_simple, e1);
  const V3 w_cross = cross3(w_simple, v1);
  const V3 v0 = pick(simple_hi, w_simple, cross3(v1, w_simple));
  const V3 v2 = pick(simple_hi, w_cross, w_simple);

  eig[0] = e0 * s;
  eig[1] = e1 * s;
  eig[2] = e2 * s;
  const V3 col[3] = {v0, v1, v2};
  for (int j = 0; j < 3; ++j) {
    // triple-degenerate: the eigenspace is everything; identity columns
    vec[0 * 3 + j] = degen ? (j == 0 ? 1.0f : 0.0f) : col[j].x;
    vec[1 * 3 + j] = degen ? (j == 1 ? 1.0f : 0.0f) : col[j].y;
    vec[2 * 3 + j] = degen ? (j == 2 ? 1.0f : 0.0f) : col[j].z;
  }
}

// The level sigmas, passed by value (no copy to the device).
constexpr int kMaxLevels = 8;
struct Sigmas {
  float v[kMaxLevels];
};

// lvl [R], zyx [R, 3] and vi [R] (null: one volume) are the candidate
// table's int64 columns. A row whose volume, level or voxel leaves the DoG
// slab's interior (the candidate tables never give one) comes back NaN,
// neither in bounds nor kept.
__global__ void __launch_bounds__(sift3d::kRowThreads)
identity_eig_kernel(const float* __restrict__ g, const float* __restrict__ dogs,
                    const int64_t* __restrict__ lvl, const int64_t* __restrict__ zyx,
                    const int64_t* __restrict__ vi, const Sigmas sig, float* __restrict__ xyz_out,
                    float* __restrict__ scale_out, float* __restrict__ pn_out,
                    float* __restrict__ eigs_out, float* __restrict__ ori_out,
                    bool* __restrict__ in_bounds, bool* __restrict__ keep, float thr, int B, int L,
                    int Z, int ND, int ZD, int Y, int X, int gz0, int dz0, int depth) {
  __shared__ float p[kPatchVox];
  __shared__ float red[6 * kRowThreads];
  __shared__ int idx[3][kPatchDim];
  __shared__ float wt[3][kPatchDim];
  __shared__ float row[4];  // x, y, z, scale
  __shared__ int live;
  const int r = blockIdx.x;
  const int l = (int)lvl[r];
  const int64_t v = vi == nullptr ? 0 : vi[r];
  const int b = v >= 0 && v < B ? (int)v : -1;  // the row's volume; -1: outside the batch
  const int z = (int)zyx[r * 3 + 0], y = (int)zyx[r * 3 + 1], x = (int)zyx[r * 3 + 2];
  const int zl = z - dz0;  // plane in the DoG slab; abscissae stay global
  if (threadIdx.x == 0) {
    live = b >= 0 && l >= 1 && l + 1 < ND && l < L && zl >= 1 && zl + 1 < ZD && y >= 1 &&
           y + 1 < Y && x >= 1 && x + 1 < X;
    if (live) {
      auto d = [&](int lv, int zz, int yy, int xx) {
        return dogs[((((size_t)b * ND + lv) * ZD + zz) * Y + yy) * X + xx];
      };
      const float dc = d(l, zl, y, x);
      const float fx = quadratic_interp(d(l, zl, y, x - 1), dc, d(l, zl, y, x + 1), (float)(x - 1),
                                        (float)x, (float)(x + 1));
      const float fy = quadratic_interp(d(l, zl, y - 1, x), dc, d(l, zl, y + 1, x), (float)(y - 1),
                                        (float)y, (float)(y + 1));
      const float fz = quadratic_interp(d(l, zl - 1, y, x), dc, d(l, zl + 1, y, x), (float)(z - 1),
                                        (float)z, (float)(z + 1));
      const float sc =
          2.0f * quadratic_interp(d(l - 1, zl, y, x), dc, d(l + 1, zl, y, x), sig.v[l - 1], sig.v[l],
                                  sig.v[l + 1]);
      const float c[3] = {fx + 0.5f, fy + 0.5f, fz + 0.5f};
      const float rad = floorf(2.0f * sc + 2.0f);
      const float hi[3] = {(float)X, (float)Y, (float)depth};
      bool inb = true;
      for (int a = 0; a < 3; ++a) {
        row[a] = c[a];
        xyz_out[r * 3 + a] = c[a];
        inb = inb && c[a] - rad >= 0.0f && c[a] + rad < hi[a];
      }
      row[3] = sc;
      scale_out[r] = sc;
      in_bounds[r] = inb;
    }
  }
  __syncthreads();
  if (!live) {  // whole block takes this branch together
    for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) pn_out[(size_t)r * kPatchVox + t] = NAN;
    if (threadIdx.x < 9) ori_out[r * 9 + threadIdx.x] = NAN;
    if (threadIdx.x < 3) xyz_out[r * 3 + threadIdx.x] = eigs_out[r * 3 + threadIdx.x] = NAN;
    if (threadIdx.x == 0) {
      scale_out[r] = NAN;
      in_bounds[r] = keep[r] = false;
    }
    return;
  }
  if (threadIdx.x < 3 * kPatchDim) {
    const int a = threadIdx.x / kPatchDim;  // 0 = x, 1 = y, 2 = z
    const int k = threadIdx.x % kPatchDim;
    identity_tap(row[a], row[3], a, k, X, Y, Z, gz0, depth, idx[a][k], wt[a][k]);
  }
  __syncthreads();
  const size_t sz = (size_t)Y * X;
  const float* gl = g + ((size_t)b * L + l) * Z * sz;
  for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) {
    const int kz = t / (kPatchDim * kPatchDim), ky = (t / kPatchDim) % kPatchDim, kx = t % kPatchDim;
    const float* q = gl + (size_t)idx[2][kz] * sz + (size_t)idx[1][ky] * X + idx[0][kx];
    p[t] = trilinear_zyx(q, sz, X, wt[2][kz], wt[1][ky], wt[0][kx]);
  }
  __syncthreads();
  normalize_patch(p, red);
  for (int t = threadIdx.x; t < kPatchVox; t += blockDim.x) pn_out[(size_t)r * kPatchVox + t] = p[t];
  // the six distinct entries of the sphere-masked gradient outer product
  float st[6];
  tree_sum_2048<6>(
      kPatchVox,
      [&](int i, float (&v)[6]) {
        float gx, gy, gz;
        patch_gradient(p, i, gx, gy, gz);
        const float m = in_sphere(i) ? 1.0f : 0.0f;
        gx = gx * m;
        gy = gy * m;
        gz = gz * m;
        v[0] = gx * gx;
        v[1] = gx * gy;
        v[2] = gx * gz;
        v[3] = gy * gy;
        v[4] = gy * gz;
        v[5] = gz * gz;
      },
      red, st);
  if (threadIdx.x == 0) {
    float e[3];
    sym_eigs_3x3(st, e, ori_out + (size_t)r * 9);
    for (int a = 0; a < 3; ++a) eigs_out[r * 3 + a] = e[a];
    // keep iff (sum)^3 < thres * prod; a negative threshold keeps all
    const float s = e[0] + e[1] + e[2];
    const float pr = e[0] * e[1] * e[2];
    keep[r] = thr < 0.0f || s * s * s < thr * pr;
  }
}

}  // namespace

// sig: ND level sigmas in host memory (ND <= 8); vi: null for one volume (B = 1).
extern "C" int sift3d_identity_eig(const float* g, const float* dogs, const int64_t* lvl,
                                   const int64_t* zyx, const int64_t* vi, const float* sig,
                                   float* xyz, float* scale, float* pn, float* eigs, float* ori,
                                   bool* in_bounds, bool* keep, float thr, int R, int B, int L,
                                   int Z, int ND, int ZD, int Y, int X, int gz0, int dz0,
                                   int depth, int device, void* stream) {
  if (ND > kMaxLevels) return (int)cudaErrorInvalidValue;
  Sigmas s = {};
  for (int i = 0; i < ND; ++i) s.v[i] = sig[i];
  SIFT3D_LAUNCH(device, identity_eig_kernel, dim3(R), dim3(sift3d::kRowThreads), stream, g, dogs, lvl,
                zyx, vi, s, xyz, scale, pn, eigs, ori, in_bounds, keep, thr, B, L, Z, ND, ZD, Y, X, gz0,
                dz0, depth);
}
