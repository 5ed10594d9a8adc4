// K1: fused difference-of-Gaussians + strict 80-neighbour extrema mask.
//
// Replaces the Pallas kernel sift3d/kernels/extrema_pallas.py:
// dogs_extrema_pallas (_dogs_extrema_kernel). Same outputs: the 5 DoGs
// g[l] - g[l+1] and an int8 mask for DoG levels 1..3 (+1 strictly above all
// 80 neighbours, -1 strictly below, 0 else; z, y, x outside [1, d-2] are 0).
//
// What bounds it on an H100: device memory. Each voxel reads 6 Gaussian
// floats (24 B) and writes 5 DoG floats + 3 mask bytes (23 B); the 80
// comparisons per mask voxel are cheap next to that.
//
// Design: a block owns a 32 x 8 (x, y) column tile and a run of 16 z-planes.
// It walks z with a ring of three DoG planes (all 5 levels, tile + 1-voxel
// halo) in shared memory, so each Gaussian value is read from device memory
// about 1.5 times (halo overhead) and each DoG is computed once, while all
// 80 comparisons read shared memory. Subtraction is exact and comparisons
// are strict, so the result is bit-identical to the plain version.

#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int TZ = 16;
constexpr int HX = TX + 2;
constexpr int HY = TY + 2;
constexpr int NL = 5;  // DoG levels

__global__ void __launch_bounds__(TX * TY)
dogs_extrema_kernel(const float* __restrict__ g, float* __restrict__ dogs,
                    int8_t* __restrict__ mask, int Z, int Y, int X) {
  __shared__ float ring[3][NL][HY][HX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;
  const int z1 = min(z0 + TZ, Z);
  const size_t plane = (size_t)Y * X;
  const size_t vol = plane * Z;

  // Compute DoG plane z (tile + halo) into its ring slot; write the DoGs of
  // this block's own voxels (z in [z0, z1), inside the tile) to `dogs`.
  auto load = [&](int z) {
    const int slot = (z + 3) % 3;
    for (int e = tid; e < HX * HY; e += TX * TY) {
      const int hy = e / HX, hx = e % HX;
      const int y = y0 + hy - 1, x = x0 + hx - 1;
      const bool inside = z >= 0 && z < Z && y >= 0 && y < Y && x >= 0 && x < X;
      const bool own = inside && hx >= 1 && hx <= TX && hy >= 1 && hy <= TY &&
                       z >= z0 && z < z1;
      const size_t off = inside ? (size_t)z * plane + (size_t)y * X + x : 0;
      float prev = inside ? g[off] : 0.0f;
      for (int l = 0; l < NL; ++l) {
        const float next = inside ? g[(size_t)(l + 1) * vol + off] : 0.0f;
        const float d = prev - next;
        ring[slot][l][hy][hx] = d;
        if (own) dogs[(size_t)l * vol + off] = d;
        prev = next;
      }
    }
  };

  load(z0 - 1);
  load(z0);
  const int x = x0 + tx, y = y0 + ty;
  for (int z = z0; z < z1; ++z) {
    load(z + 1);
    __syncthreads();
    if (x < X && y < Y) {
      int8_t m[3] = {0, 0, 0};
      if (z >= 1 && z <= Z - 2 && y >= 1 && y <= Y - 2 && x >= 1 && x <= X - 2) {
        for (int c = 1; c <= 3; ++c) {
          const float v = ring[z % 3][c][ty + 1][tx + 1];
          bool gt = true, lt = true;
          for (int dl = -1; dl <= 1; ++dl) {
            for (int dz = -1; dz <= 1; ++dz) {
              const int slot = (z + dz + 3) % 3;
              for (int dy = -1; dy <= 1; ++dy) {
                for (int dx = -1; dx <= 1; ++dx) {
                  if (dl == 0 && dz == 0 && dy == 0 && dx == 0) continue;
                  const float n = ring[slot][c + dl][ty + 1 + dy][tx + 1 + dx];
                  gt = gt && (v > n);
                  lt = lt && (v < n);
                }
              }
            }
          }
          m[c - 1] = gt ? 1 : (lt ? -1 : 0);
        }
      }
      const size_t off = (size_t)z * plane + (size_t)y * X + x;
      for (int c = 0; c < 3; ++c) mask[(size_t)c * vol + off] = m[c];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sift3d_dogs_extrema(const float* g, float* dogs, int8_t* mask,
                                   int Z, int Y, int X, int device, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (Z + TZ - 1) / TZ);
  SIFT3D_LAUNCH(device, dogs_extrema_kernel, grid, block, stream, g, dogs, mask, Z, Y, X);
}
