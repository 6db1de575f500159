// Corner-weight and (level, point) reduce of multi-scale deformable attention
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels tair_tpu/ops/msda_reduce.py::_fwd_kernel (driven by
// _fwd_impl; _fwd_kernel_mxt is the same function laid out for the TPU's
// matrix unit, and _fwd_kernel_noweights is that function with every weight
// set to 1) and ::_bwd_kernel (driven by _vjp_bwd). Forward:
//   out[n*G + h, :] = sum_{j<K} sum_{c<4} w_c[n, h*K + j]
//                                        * g[n*lanes + h*K + j, c*D:(c+1)*D]
// with G = lanes / K groups per query.
//
// Bound on this card: bytes. Each value of g is read once and used in one
// multiply-add, so the least time is the size of g (plus the weights and the
// output) over the memory rate; no arithmetic trick helps, only reading g once
// with full-width, coalesced loads.
//
// Design: one warp per output row. The K rows of g that feed one output row
// are contiguous (K * 4D values), so the warp streams them with 16-byte loads,
// 512 bytes per instruction. A lane keeps the same corner and the same D
// columns in every iteration, so it accumulates in registers; lanes that hold
// the same columns are then summed with shuffles and the first D/N lanes write
// the row. Ragged NQ needs no padding: a warp past the last row exits.
//
// Backward, for the cotangent dO [NQ*G, D] of out:
//   dg[n*lanes + h*K + j, c*D:(c+1)*D] = w_c[n, h*K + j] * dO[n*G + h, :]
//   dw_c[n, h*K + j] = sum_d g[n*lanes + h*K + j, c*D + d] * dO[n*G + h, d]
// dg is as large as g and each of its values is written once, so the bound is
// bytes again: g read, dg written, the weights read and their gradients
// written. Same layout: one warp per output row, now writing. A lane keeps its
// corner and its D columns, so it loads its piece of the row's dO once; per
// 16-byte piece of g it stores w * dO as 16 bytes of dg in g's type and forms
// the partial dot product g . dO, which the D/N neighbouring lanes that hold
// the rest of the same corner fold with shuffles before one of them writes
// dw_c.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_load.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_corner_reduce_kernel(const T* __restrict__ g, const float* __restrict__ w0,
                          const float* __restrict__ w1,
                          const float* __restrict__ w2,
                          const float* __restrict__ w3, float* __restrict__ out,
                          int64_t n_rows, int lanes, int K, int D) {
  constexpr int N = VecLoad<T>::N;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int groups = lanes / K;
  const int64_t n = row / groups;
  const int h = static_cast<int>(row - n * groups);

  const int vpr = 4 * D / N;  // 16-byte vectors in one row of g; divides 32
  const int e0 = (lane % vpr) * N;
  const int c = e0 / D;
  const float* w = (c == 0 ? w0 : c == 1 ? w1 : c == 2 ? w2 : w3) +
                   n * lanes + static_cast<int64_t>(h) * K;
  const T* gp = g + (n * lanes + static_cast<int64_t>(h) * K) * 4 * D;

  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;

  const int total = K * vpr;
  for (int vi = lane; vi < total; vi += 32) {
    float vals[N];
    VecLoad<T>::load(gp + static_cast<int64_t>(vi) * N, vals);
    const float wj = w[vi / vpr];
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] += wj * vals[e];
  }

  // lanes that agree modulo D/N hold the same output columns
  const int dn = D / N;
  for (int off = 16; off >= dn; off >>= 1) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (lane < dn) {
    float* op = out + row * D + lane * N;
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(op + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_corner_reduce_bwd_kernel(const T* __restrict__ g,
                              const float* __restrict__ w0,
                              const float* __restrict__ w1,
                              const float* __restrict__ w2,
                              const float* __restrict__ w3,
                              const float* __restrict__ dout,
                              T* __restrict__ dg, float* __restrict__ dw0,
                              float* __restrict__ dw1, float* __restrict__ dw2,
                              float* __restrict__ dw3, int64_t n_rows,
                              int lanes, int K, int D) {
  constexpr int N = VecLoad<T>::N;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int groups = lanes / K;
  const int64_t n = row / groups;
  const int h = static_cast<int>(row - n * groups);

  const int vpr = 4 * D / N;  // 16-byte vectors in one row of g; divides 32
  const int e0 = (lane % vpr) * N;
  const int c = e0 / D;
  const int64_t w_at = n * lanes + static_cast<int64_t>(h) * K;
  const float* w = (c == 0 ? w0 : c == 1 ? w1 : c == 2 ? w2 : w3) + w_at;
  float* dw = (c == 0 ? dw0 : c == 1 ? dw1 : c == 2 ? dw2 : dw3) + w_at;
  const int64_t g_at = w_at * 4 * D;

  float dov[N];
  VecLoad<float>::load(dout + row * D + (e0 - c * D), dov);
  if constexpr (N == 8)
    VecLoad<float>::load(dout + row * D + (e0 - c * D) + 4, dov + 4);

  const int dn = D / N;  // lanes that share one (row of g, corner)
  const int total = K * vpr;
  for (int base = 0; base < total; base += 32) {  // uniform, so shuffles are safe
    const int vi = base + lane;
    const bool active = vi < total;
    float dot = 0.f;
    if (active) {
      float vals[N], outv[N];
      VecLoad<T>::load(g + g_at + static_cast<int64_t>(vi) * N, vals);
      const float wj = w[vi / vpr];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        outv[e] = wj * dov[e];
        dot += vals[e] * dov[e];
      }
      VecLoad<T>::store(dg + g_at + static_cast<int64_t>(vi) * N, outv);
    }
    for (int off = dn >> 1; off >= 1; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (active && (lane % dn) == 0) dw[vi / vpr] = dot;
  }
}

template <typename T>
bool shape_ok(int lanes, int K, int D) {
  constexpr int N = VecLoad<T>::N;
  const int vpr = 4 * D / N;
  // a lane must keep one corner and one set of columns: D a multiple of the
  // vector width, and the vectors of a row of g dividing the warp
  return D % N == 0 && vpr >= 1 && vpr <= 32 && (32 % vpr) == 0 && lanes % K == 0;
}

template <typename T>
int launch_bwd(const void* g, const float* w0, const float* w1, const float* w2,
               const float* w3, const float* dout, void* dg, float* dw0,
               float* dw1, float* dw2, float* dw3, int64_t nq, int lanes, int K,
               int D, cudaStream_t stream) {
  if (!shape_ok<T>(lanes, K, D)) return -1;
  const int64_t n_rows = nq * (lanes / K);
  if (n_rows == 0) return 0;
  const int64_t blocks = (n_rows * 32 + kThreads - 1) / kThreads;
  msda_corner_reduce_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                     stream>>>(
      static_cast<const T*>(g), w0, w1, w2, w3, dout, static_cast<T*>(dg), dw0,
      dw1, dw2, dw3, n_rows, lanes, K, D);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* g, const float* w0, const float* w1, const float* w2,
           const float* w3, float* out, int64_t nq, int lanes, int K, int D,
           cudaStream_t stream) {
  if (!shape_ok<T>(lanes, K, D)) return -1;
  const int64_t n_rows = nq * (lanes / K);
  if (n_rows == 0) return 0;
  const int64_t blocks = (n_rows * 32 + kThreads - 1) / kThreads;
  msda_corner_reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(static_cast<const T*>(g), w0, w1, w2,
                                           w3, out, n_rows, lanes, K, D);
  return cudaGetLastError();
}

}  // namespace

// g [nq*lanes, 4*D] contiguous (dtype 0 float, 1 bfloat16); w0..w3 [nq, lanes]
// float contiguous; out [nq*(lanes/K), D] float contiguous. Returns the CUDA
// error code of the launch (0 on success), -1 for a shape or type that has no
// kernel.
extern "C" int msda_corner_reduce_fwd(const void* g, const float* w0,
                                      const float* w1, const float* w2,
                                      const float* w3, float* out, int64_t nq,
                                      int lanes, int K, int D, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(g, w0, w1, w2, w3, out, nq, lanes, K, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, w0, w1, w2, w3, out, nq, lanes, K, D, s);
  return -1;
}

// g, w0..w3 as in the forward; dout [nq*(lanes/K), D] float contiguous; dg like
// g; dw0..dw3 [nq, lanes] float contiguous. Same return codes.
extern "C" int msda_corner_reduce_bwd(const void* g, const float* w0,
                                      const float* w1, const float* w2,
                                      const float* w3, const float* dout,
                                      void* dg, float* dw0, float* dw1,
                                      float* dw2, float* dw3, int64_t nq,
                                      int lanes, int K, int D, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, w0, w1, w2, w3, dout, dg, dw0, dw1, dw2, dw3,
                             nq, lanes, K, D, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, w0, w1, w2, w3, dout, dg, dw0, dw1, dw2,
                                     dw3, nq, lanes, K, D, s);
  return -1;
}
