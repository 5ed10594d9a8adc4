// 2x linear upsampling of a batch of volumes: featExtract's -2+
// (fioDoubleSize, FeatureIO.cpp:2453-2548).
//
// Replaces no TPU kernel: the JAX package doubles a volume eagerly, one XLA
// op at a time (sift3d/kernels/resample.py: double_size), and so does the
// port's plain version (sift3d_torch/kernels/resample.py: double_size), a
// chain of cat, add, multiply, stack, reshape and movedim per axis whose
// temporaries reach 2, 4 and 8 times the input. This kernel takes its place
// on the card, in one pass over a contiguous f32 [B, Z, Y, X] batch into a
// contiguous f32 [B, OZ, OY, OX] output (O = 2n for an axis of n > 1, else
// 1), with the plain chain's arithmetic, bit for bit: the z pass, then y,
// then x, each output of a doubled axis
//   out[2i] = v[i],  out[2i + 1] = 0.5 * (v[i] + v[min(i + 1, n - 1)])
// (the last cell clamped), each sum and product rounded to f32 (__fadd_rn,
// __fmul_rn: never contracted).
//
// What bounds it on an H100: device memory. It reads 4 bytes a voxel of the
// input and writes 32 (a 182x218x182 volume: 28.9 MB in, 231 MB out, 69 us
// at 3.35 TB/s). Design: a thread takes one input column (y, x) of one
// output plane oz and writes its 2 x 2 outputs in rows 2y and 2y + 1 as two
// 8-byte stores, neighbouring threads on neighbouring columns; it reads the
// (at most) 2 x 2 x 2 inputs it needs, which its neighbours read too, from
// L1/L2, so device memory sees each input plane about once per output plane
// pair. Blocks walk (y, x) fastest, then oz, then the volume.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float mid(float a, float b) { return __fmul_rn(0.5f, __fadd_rn(a, b)); }

// output index o of an axis of n inputs: its input index i0, the next one
// i1 (clamped) and whether it is the odd, interpolated one; an axis of
// length 1 is not doubled
__device__ __forceinline__ void pick(int o, int n, int& i0, int& i1, bool& odd) {
  if (n > 1) {
    i0 = o >> 1;
    odd = o & 1;
    i1 = min(i0 + 1, n - 1);
  } else {
    i0 = i1 = o;
    odd = false;
  }
}

__global__ void __launch_bounds__(THREADS)
double_size_kernel(const float* __restrict__ in, float* __restrict__ out, int Z, int Y, int X, int OZ,
                   int OY, int OX, bool pairs) {
  const long long plane = (long long)Y * X;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= plane) return;
  const int j = (int)(idx / X), t = (int)(idx - (long long)j * X);
  const int oz = blockIdx.y, b = blockIdx.z;
  int i0, i1;
  bool zodd;
  pick(oz, Z, i0, i1, zodd);
  const float* p0 = in + ((size_t)b * Z + i0) * plane;
  const float* p1 = in + ((size_t)b * Z + i1) * plane;
  const int j1 = min(j + 1, Y - 1), t1 = min(t + 1, X - 1);
  // the z pass at the four columns this thread needs
  auto vz = [&](int y, int x) {
    const size_t o = (size_t)y * X + x;
    const float a = p0[o];
    return zodd ? mid(a, p1[o]) : a;
  };
  const float a00 = vz(j, t), a01 = vz(j, t1);
  // the y pass: row 2j (or row j of an undoubled y) takes a0*, row 2j + 1 mid(a0*, a1*)
  float rows[2][2] = {{a00, a01}, {0.0f, 0.0f}};
  const bool ydbl = Y > 1;
  if (ydbl) {
    const float a10 = vz(j1, t), a11 = vz(j1, t1);
    rows[1][0] = mid(a00, a10);
    rows[1][1] = mid(a01, a11);
  }
  const int oy0 = ydbl ? 2 * j : j;
  for (int r = 0; r < (ydbl ? 2 : 1); ++r) {
    float* row = out + (((size_t)b * OZ + oz) * OY + oy0 + r) * OX;
    // the x pass: column 2t, then 2t + 1
    if (X > 1) {
      const float2 v = make_float2(rows[r][0], mid(rows[r][0], rows[r][1]));
      if (pairs)
        reinterpret_cast<float2*>(row)[t] = v;
      else {
        row[2 * t] = v.x;
        row[2 * t + 1] = v.y;
      }
    } else {
      row[t] = rows[r][0];
    }
  }
}

}  // namespace

// in [B, Z, Y, X] f32, out [B, OZ, OY, OX] f32, both contiguous on the
// device, O = 2n for an axis of n > 1, else 1; B, Z <= 65535 (the grid's y
// and z).
extern "C" int sift3d_double_size(const float* in, float* out, int B, int Z, int Y, int X, int device,
                                  void* stream) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int OZ = Z > 1 ? 2 * Z : 1, OY = Y > 1 ? 2 * Y : 1, OX = X > 1 ? 2 * X : 1;
  if (OZ > 65535) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)Y * X;
  const dim3 grid((unsigned)((plane + THREADS - 1) / THREADS), OZ, B);
  // 8-byte stores where every output row starts 8-byte aligned
  const bool pairs = ((uintptr_t)out & 7) == 0;
  SIFT3D_LAUNCH(device, double_size_kernel, grid, dim3(THREADS), stream, in, out, Z, Y, X, OZ, OY, OX,
                pairs);
}
