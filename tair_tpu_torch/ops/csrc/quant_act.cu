// Per-tensor symmetric int8 quantize of an activation (Q2 of the w8a8 serving
// path) for Hopper (sm_90a), plain C interface.
//
// No Pallas kernel stands behind it: it is tair_tpu/ops/quant.py::_quant_act,
// which XLA fuses in front of the s8 x s8 -> s32 product there. Function, for
// x [rows, C] (float32 or bfloat16, contiguous):
//   amax     = max |x|                    (dynamic; NaN if x holds one) or the
//                                          caller's amax (static)
//   scale    = amax <= 0 ? 1 : amax / 127 (IEEE division, as the JAX package;
//                                          a NaN amax gives a NaN scale)
//   x8[r, c] = rint(x[r, c] / scale)      (half to even; clipped to +-127 on the
//                                          static path) for c < C, 0 for C <= c < Cp
//   stats    = (amax, scale)
// x8 is [rows, Cp] with Cp a multiple of 16: channels innermost, padded, the
// layout the int8 convolution (int8_conv.cu) reads in 16-byte pieces.
//
// Bound on this card: bytes (x read, x8 written). Design: the dynamic path is
// two launches with no atomics and no memset. Pass 1: each of n_partial blocks
// folds a grid-stride share of x, 16-byte loads, into one partial maximum.
// Pass 2: every block folds the n_partial maxima (a few hundred floats, from
// L2) with one warp, so the scale never leaves the device and the host never
// waits; block 0 writes stats; then each thread writes 8 int8 values at a time
// as one 8-byte store. The static path is pass 2 alone. The division stays a
// division (no reciprocal), so the kernel equals its plain version bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_load.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartial = 1024;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// max that keeps a NaN (fmaxf drops it), as the plain version's amax() does
__device__ inline float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ inline float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, int64_t n, int vec, float* __restrict__ partial) {
  constexpr int N = VecLoad<T>::N;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nth = static_cast<int64_t>(gridDim.x) * kThreads;
  float m = 0.f;
  int64_t tail = 0;
  if (vec) {
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += nth) {
      float v[N];
      VecLoad<T>::load(x + i * N, v);
#pragma unroll
      for (int e = 0; e < N; ++e) m = max_nan(m, fabsf(v[e]));
    }
    tail = nv * N;
  }
  for (int64_t i = tail + tid; i < n; i += nth) m = max_nan(m, fabsf(to_float(x[i])));

  __shared__ float warp_maxima[kThreads / 32];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) warp_maxima[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_maxima[threadIdx.x] : 0.f;
    m = warp_max(m);
    if (threadIdx.x == 0) partial[blockIdx.x] = m;
  }
}

template <typename T>
__device__ inline void load8(const T* p, bool vec, int valid, float (&v)[8]) {
  if (vec && valid >= 8) {
    constexpr int N = VecLoad<T>::N;
#pragma unroll
    for (int j = 0; j < 8; j += N) VecLoad<T>::load(p + j, v + j);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? to_float(p[e]) : 0.f;
  }
}

template <typename T, bool kStatic>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int64_t rows, int C, int Cp, int vec,
                const float* __restrict__ partial, int n_partial, float static_amax,
                int8_t* __restrict__ x8, float* __restrict__ stats) {
  __shared__ float s_scale;
  if (threadIdx.x < 32) {
    float amax = static_amax;
    if (!kStatic) {
      float m = 0.f;
      for (int i = threadIdx.x; i < n_partial; i += 32) m = max_nan(m, partial[i]);
      amax = warp_max(m);
    }
    if (threadIdx.x == 0) {
      const float scale = amax <= 0.f ? 1.f : __fdiv_rn(amax, 127.f);
      s_scale = scale;
      if (blockIdx.x == 0) {
        stats[0] = amax;
        stats[1] = scale;
      }
    }
  }
  __syncthreads();
  const float scale = s_scale;
  const int groups = Cp / 8;
  const int64_t total = rows * groups;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = i / groups;
    const int c0 = static_cast<int>(i - r * groups) * 8;
    float v[8];
    load8(x + r * C + c0, vec, C - c0, v);
    union {
      int8_t b[8];
      uint2 u;
    } q;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float t = rintf(__fdiv_rn(v[e], scale));
      if (kStatic) t = fminf(fmaxf(t, -127.f), 127.f);
      q.b[e] = static_cast<int8_t>(static_cast<int>(t));
    }
    *reinterpret_cast<uint2*>(x8 + r * Cp + c0) = q.u;
  }
}

template <typename T>
int launch(const T* x, int64_t rows, int C, int Cp, int8_t* x8, float* partial,
           int n_partial, float* stats, bool is_static, float static_amax,
           cudaStream_t stream) {
  // 16-byte loads need every row to start on a 16-byte boundary
  const int per16 = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int64_t total = rows * (Cp / 8);
  const int blocks = static_cast<int>(
      total / kThreads + 1 < 132 * 16 ? total / kThreads + 1 : 132 * 16);
  if (is_static) {
    quantize_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        x, rows, C, Cp, aligned && C % per16 == 0, nullptr, 0, static_amax, x8, stats);
    return cudaGetLastError();
  }
  absmax_kernel<T><<<n_partial, kThreads, 0, stream>>>(x, rows * C, aligned, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
      x, rows, C, Cp, aligned && C % per16 == 0, partial, n_partial, 0.f, x8, stats);
  return cudaGetLastError();
}

}  // namespace

// x: [rows, C] float32 (dtype 0) or bfloat16 (dtype 1), contiguous; x8: [rows,
// Cp] int8, 8-byte aligned; partial: n_partial floats of scratch (dynamic path
// only); stats: 2 floats out. Returns 0, -1 for arguments the kernels do not
// take, or the CUDA error of a launch.
extern "C" int quant_act_s8(const void* x, int dtype, int64_t rows, int C, int Cp, void* x8,
                            void* partial, int n_partial, void* stats, int is_static,
                            float static_amax, void* stream) {
  if (rows < 1 || C < 1 || Cp < C || Cp % 16 || reinterpret_cast<uintptr_t>(x8) % 8) return -1;
  if (!is_static && (partial == nullptr || n_partial < 1 || n_partial > kMaxPartial)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(x8);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return launch(static_cast<const float*>(x), rows, C, Cp, q, p, n_partial, st, is_static,
                  static_amax, s);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), rows, C, Cp, q, p, n_partial, st,
                  is_static, static_amax, s);
  return -1;
}
