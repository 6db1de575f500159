// Tile geometry and the global-to-shared tile copy shared by the flash
// attention forward and backward kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_load.cuh"

namespace flash {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // keys per tile

// Copies a rows x cols tile (cols contiguous) into shared memory as float,
// times mult; rows at or past rows_valid are filled with zeros.
template <typename T>
__device__ inline void load_tile(float* dst, int ld, const T* src,
                                 int64_t row_stride, int rows, int rows_valid,
                                 int cols, float mult) {
  constexpr int N = VecLoad<T>::N;
  const int vpr = cols / N;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += kThreads) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * N;
    float vals[N];
    if (r < rows_valid) {
      VecLoad<T>::load(src + static_cast<int64_t>(r) * row_stride + c, vals);
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] *= mult;
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] = 0.f;
    }
    float* d = dst + r * ld + c;
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      *reinterpret_cast<float4*>(d + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
    }
  }
}

}  // namespace flash
