// 16-byte global loads of float or bfloat16 values, widened to float, and the
// matching 16-byte stores of float values narrowed to the tensor's type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
struct VecLoad;

template <>
struct VecLoad<float> {
  static constexpr int N = 4;
  __device__ static inline void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static inline void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct VecLoad<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static inline void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static inline void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ inline void store_value(float* p, float x) { *p = x; }
__device__ inline void store_value(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
