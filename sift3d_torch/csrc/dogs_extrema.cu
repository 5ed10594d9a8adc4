// K1: fused difference-of-Gaussians + strict 80-neighbour extrema mask.
// K6: the same mask from precomputed DoGs.
//
// Replaces the Pallas kernels sift3d/kernels/extrema_pallas.py:
// dogs_extrema_pallas (_dogs_extrema_kernel, K1) and extrema_mask_pallas
// (_extrema_kernel, K6). K1 takes a batch of B volumes' octave stacks,
// [B, 6, Z, Y, X] Gaussian levels (batched extraction's one pyramid per shape
// group), and writes the 5 DoGs g[l] - g[l+1] of each and the mask; K6 takes
// [B, 5, Z, Y, X] DoGs (the Z-sharded path's one-plane-halo DoG slabs) and
// writes only the mask. The
// mask is int8 for DoG levels 1..3: +1 strictly above all 80 neighbours, -1
// strictly below, 0 else; z, y, x outside [1, d-2] are 0.
//
// The bound on an H100 is device memory: K1 reads 6 Gaussian floats (24 B)
// and writes 5 DoG floats + 3 mask bytes (23 B) a voxel, K6 reads 5 DoG
// floats and writes 3 bytes. The first design (a block of 32 x 8 threads on
// a ring of three DoG planes in shared memory, 80 strict comparisons a
// centre level, every operand a shared load, two barriers a plane) ran at
// about a quarter of that: the comparisons, up to 243 shared loads a voxel,
// set its time, and K6, with half K1's bytes, took 97% of K1's time.
//
// Design: the 80-neighbour test by separation, exact. v is +1 iff
// v > max(80 neighbours) and -1 iff v < min(80 neighbours); max and min are
// exact, so the bits are the strict comparisons' bits. Per level and plane:
//   row3 = max/min over x-1..x+1,
//   R8   = max/min of row3[y-1], row3[y+1], v[x-1], v[x+1] (the 3 x 3
//          square without its centre),
//   B9   = max/min of row3 over y-1..y+1 (the square; R8 and v for the
//          centre levels 1..3).
// With W(z) = B9 of levels c-1, c, c+1 at plane z and U(z) = B9 of levels
// c-1 and c+1, the 80 neighbours of centre level c at plane z are
// W(z-1), U(z), R8 of level c at z, and W(z+1). max/min are PTX max.NaN /
// min.NaN: a NaN anywhere among the 81 values propagates and fails both
// strict tests, as it fails the plain version's comparisons (fmaxf would
// drop it).
//
// A block is a (TY + 2) x 32 array of threads, one (y, x) column each, that
// walks a run of ZR planes (plus one plane of halo on each side). A warp
// loads 32 adjacent x columns and emits the 30 inside: x neighbours come by
// shuffle; y neighbours from row3 in shared memory, double-buffered by plane
// parity, so a plane costs one barrier and 15 shared accesses a thread (5
// float2 stores, 10 float2 loads). W of the previous plane, the span of what
// centre plane z - 1 has seen so far and its values live in registers; the
// next plane's inputs are loaded while the current plane is worked. Each
// input is read once plus the tile's halo (32/30 in x, (TY+2)/TY in y,
// (ZR+2)/ZR in z; neighbouring blocks' halos mostly hit L2); each DoG and
// mask byte is written once, by the one thread that owns its voxel. TY (16,
// 8 or 4) and ZR are chosen per shape and kernel by
// sift3d_torch.kernels.extrema_cuda.extrema_launch_geometry.
//
// What limits it (H100 80GB HBM3, 700 W; chip_smoke.py phase 2's sweeps and
// scripts/torch_extrema_bounds.py): K1 device memory, at about 1.9 TB/s on
// the T1 stack: without the neighbourhood test it takes as long, and many
// short z runs (more blocks spread over the stack) beat less halo. K6 its
// instructions: with its inputs made from the coordinates instead of loaded
// it takes as long, and capping its registers so that more blocks fit on an
// SM makes it slower.

#include "common.cuh"

namespace {

constexpr int NL = 5;       // DoG levels
constexpr int LANES = 32;   // x columns a warp loads
constexpr int TX = LANES - 2;  // x columns a warp emits
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (max, min) of two and of three (max, min) pairs
__device__ __forceinline__ float2 span2(float2 a, float2 b) {
  return make_float2(max_nan(a.x, b.x), min_nan(a.y, b.y));
}

__device__ __forceinline__ float2 span3(float2 a, float2 b, float2 c) {
  return span2(span2(a, b), c);
}

// (max, min) of a pair and a value
__device__ __forceinline__ float2 span_v(float2 a, float v) {
  return make_float2(max_nan(a.x, v), min_nan(a.y, v));
}

// blockIdx.z runs over batch x z runs. kFromStack: `in` is [B, 6, Z, Y, X]
// Gaussian stacks and the DoGs are also written to `dogs` [B, 5, Z, Y, X];
// else `in` is [B, 5, Z, Y, X] DoGs and `dogs` is unused. Every offset into a
// batch is size_t: a batch of T1 stacks passes 2^32 bytes.
template <bool kFromStack, int TY>
__device__ __forceinline__ void extrema_body(const float* __restrict__ in,
                                             float* __restrict__ dogs,
                                             int8_t* __restrict__ mask, int Z, int Y, int X,
                                             int zr, int z_runs) {
  constexpr int ROWS = TY + 2;
  constexpr int NIN = kFromStack ? NL + 1 : NL;
  __shared__ float2 row3[2][NL][ROWS][LANES];  // row3 (max, min), by plane parity
  const int lane = threadIdx.x, row = threadIdx.y;
  const int b = blockIdx.z / z_runs, run = blockIdx.z % z_runs;
  const int x = blockIdx.x * TX + lane, y = blockIdx.y * TY + row;
  const size_t plane = (size_t)Y * X;
  const size_t vol = plane * Z;
  in += (size_t)b * NIN * vol;
  mask += (size_t)b * 3 * vol;
  if (kFromStack) dogs += (size_t)b * NL * vol;
  const bool in_xy = x < X && y < Y;
  // the one thread of the grid that writes (z, y, x) for each z of its run:
  // a tile's inside columns and rows, and the volume's first and last ones
  // from the first and last tiles
  const bool own_xy = in_xy && (lane >= 1 || blockIdx.x == 0) &&
                      (lane <= TX || blockIdx.x == gridDim.x - 1) &&
                      (row >= 1 || blockIdx.y == 0) && (row <= TY || blockIdx.y == gridDim.y - 1);
  const bool inner_xy = x >= 1 && x <= X - 2 && y >= 1 && y <= Y - 2;
  const bool emit = own_xy && inner_xy;  // implies lane in 1..TX and row in 1..TY
  const size_t xy = in_xy ? (size_t)y * X + x : 0;
  const float* src = in + xy;
  float* dst = kFromStack ? dogs + xy : nullptr;
  int8_t* msk = mask + xy;
  const int zs = run * zr;                   // first plane loaded
  const int ze = min(zs + zr + 1, Z - 1);    // last plane loaded
  const bool first_run = run == 0, last_run = run == z_runs - 1;
  const int ru = row > 0 ? row - 1 : row, rd = row < ROWS - 1 ? row + 1 : row;

  float nxt[NIN];
  auto load = [&](int z) {
    const size_t off = (size_t)z * plane;
#pragma unroll
    for (int l = 0; l < NIN; ++l) nxt[l] = in_xy ? src[l * vol + off] : 0.0f;
  };
  load(zs);
  // carried from plane p - 1 for centre levels c = 1..3: W = B9 of levels
  // c - 1, c, c + 1; the span of the neighbours known by then (W at p - 2,
  // B9 of levels c - 1 and c + 1 and R8 of level c at p - 1); the value
  float2 wp[3], part[3];
  float ctr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wp[c] = part[c] = make_float2(0.0f, 0.0f);
    ctr[c] = 0.0f;
  }

#pragma unroll 2
  for (int p = zs; p <= ze; ++p) {
    float d[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) d[l] = kFromStack ? nxt[l] - nxt[l + 1] : nxt[l];
    if (p < ze) load(p + 1);
    const size_t off = (size_t)p * plane;
    if ((p > zs || first_run) && (p <= zs + zr || last_run) && own_xy) {
      if (kFromStack) {
#pragma unroll
        for (int l = 0; l < NL; ++l) dst[l * vol + off] = d[l];
      }
      if (!(inner_xy && p >= 1 && p <= Z - 2)) {
#pragma unroll
        for (int c = 0; c < 3; ++c) msk[c * vol + off] = 0;
      }
    }
    float2 r3[NL];
    float xl[3], xr[3];
    float2(*buf)[ROWS][LANES] = row3[p & 1];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float a = __shfl_up_sync(FULL, d[l], 1), c = __shfl_down_sync(FULL, d[l], 1);
      r3[l] = span_v(make_float2(max_nan(a, c), min_nan(a, c)), d[l]);
      buf[l][row][lane] = r3[l];
      if (l >= 1 && l <= 3) {
        xl[l - 1] = a;
        xr[l - 1] = c;
      }
    }
    __syncthreads();
    float2 b9[NL], r8[3];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float2 up = buf[l][ru][lane], dn = buf[l][rd][lane];
      if (l >= 1 && l <= 3) {
        // R8: rows y - 1 and y + 1 and the two x neighbours; B9 adds the centre
        r8[l - 1] = span2(span2(up, dn), make_float2(max_nan(xl[l - 1], xr[l - 1]),
                                                     min_nan(xl[l - 1], xr[l - 1])));
        b9[l] = span_v(r8[l - 1], d[l]);
      } else {
        b9[l] = span3(up, r3[l], dn);
      }
    }
    int8_t m[3];
#pragma unroll
    for (int c = 1; c <= 3; ++c) {
      const float2 u = span2(b9[c - 1], b9[c + 1]);
      const float2 w = span2(u, b9[c]);
      const float2 n = span2(part[c - 1], w);  // all 80 neighbours of centre plane p - 1
      const float v = ctr[c - 1];
      m[c - 1] = v > n.x ? 1 : (v < n.y ? -1 : 0);
      part[c - 1] = span3(wp[c - 1], u, r8[c - 1]);
      wp[c - 1] = w;
      ctr[c - 1] = d[c];
    }
    if (emit && p >= zs + 2) {  // centre plane p - 1 is inside and this run's
      const size_t coff = (size_t)(p - 1) * plane;
#pragma unroll
      for (int c = 0; c < 3; ++c) msk[c * vol + coff] = m[c];
    }
  }
}

template <int TY>
__global__ void __launch_bounds__(LANES * (TY + 2))
dogs_extrema_kernel(const float* __restrict__ g, float* __restrict__ dogs,
                    int8_t* __restrict__ mask, int Z, int Y, int X, int zr, int z_runs) {
  extrema_body<true, TY>(g, dogs, mask, Z, Y, X, zr, z_runs);
}

template <int TY>
__global__ void __launch_bounds__(LANES * (TY + 2))
extrema_mask_kernel(const float* __restrict__ dogs, int8_t* __restrict__ mask, int Z, int Y,
                    int X, int zr, int z_runs) {
  extrema_body<false, TY>(dogs, nullptr, mask, Z, Y, X, zr, z_runs);
}

// tiles of t emitted positions over the d - 2 inside ones; at least one, so
// that a volume with no inside still has its DoGs and zero mask written
int tiles(int d, int t) { return d > 2 ? (d - 2 + t - 1) / t : 1; }

template <int TY>
int launch(const float* in, float* dogs, int8_t* mask, int B, int Z, int Y, int X, int zr,
           int device, void* stream) {
  const int z_runs = tiles(Z, zr);
  const dim3 grid(tiles(X, TX), tiles(Y, TY), B * z_runs), block(LANES, TY + 2);
  if (dogs != nullptr) {
    SIFT3D_LAUNCH(device, dogs_extrema_kernel<TY>, grid, block, stream, in, dogs, mask, Z, Y, X,
                  zr, z_runs);
  }
  SIFT3D_LAUNCH(device, extrema_mask_kernel<TY>, grid, block, stream, in, mask, Z, Y, X, zr,
                z_runs);
}

// ty in {16, 8, 4}, zr >= 1 (extrema_cuda.extrema_launch_geometry)
int launch_any(const float* in, float* dogs, int8_t* mask, int B, int Z, int Y, int X, int ty,
               int zr, int device, void* stream) {
  if (zr < 1) return (int)cudaErrorInvalidValue;
  switch (ty) {
    case 16: return launch<16>(in, dogs, mask, B, Z, Y, X, zr, device, stream);
    case 8: return launch<8>(in, dogs, mask, B, Z, Y, X, zr, device, stream);
    case 4: return launch<4>(in, dogs, mask, B, Z, Y, X, zr, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sift3d_dogs_extrema(const float* g, float* dogs, int8_t* mask, int B, int Z, int Y,
                                   int X, int ty, int zr, int device, void* stream) {
  return launch_any(g, dogs, mask, B, Z, Y, X, ty, zr, device, stream);
}

extern "C" int sift3d_extrema_mask(const float* dogs, int8_t* mask, int B, int Z, int Y, int X,
                                   int ty, int zr, int device, void* stream) {
  return launch_any(dogs, nullptr, mask, B, Z, Y, X, ty, zr, device, stream);
}
