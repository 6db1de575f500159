// Lab for the msda corner-reduce kernel on Hopper (sm_90a), plain C interface.
//
// Replaces the TPU lab scripts/msda_kernel_lab.py (bodies _copy_kernel,
// _seg_kernel, _segw_kernel, _segw16_kernel, driven by build()): the work of
// the corner reduce (msda_reduce.cu) cut into stages, to see where its time
// goes. All variants keep that kernel's mapping (one warp per output row, the
// K rows of g that feed it streamed with 16-byte loads, a lane keeping one
// corner and one set of D columns) and take g [NQ*lanes, 4D] in bfloat16:
//   copy  read every value of g and store, per output row, the first D values
//         of its first row of g: the reading alone;
//   seg   out[n*G + h, :] = sum_j sum_c g[n*lanes + h*K + j, c*D:(c+1)*D]:
//         reading and adding, no weights;
//   w32   the full reduce, each product w * g formed in float32;
//   w16   the full reduce with the weight rounded to bfloat16 and the product
//         formed two at a time in bfloat16 (one rounding more), summed in
//         float32. Not equal to the shipped kernel bit for bit.
// The shipped kernel is timed beside them through its own wrapper.
//
// Bound on this card: bytes for every variant (g read once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int N = 8;  // bfloat16 values in one 16-byte piece

enum Variant { kCopy = 0, kSeg = 1, kW32 = 2, kW16 = 3 };

__device__ inline uint4 load_piece(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// A load the compiler may not drop though its result is unused.
__device__ inline uint4 load_piece_kept(const __nv_bfloat16* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
lab_kernel(const __nv_bfloat16* __restrict__ g, const float* __restrict__ w0,
           const float* __restrict__ w1, const float* __restrict__ w2,
           const float* __restrict__ w3, float* __restrict__ out,
           int64_t n_rows, int lanes, int K, int D) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int groups = lanes / K;
  const int64_t n = row / groups;
  const int h = static_cast<int>(row - n * groups);

  const int vpr = 4 * D / N;  // 16-byte pieces in one row of g; divides 32
  const int e0 = (lane % vpr) * N;
  const int c = e0 / D;
  const float* w = (c == 0 ? w0 : c == 1 ? w1 : c == 2 ? w2 : w3) +
                   n * lanes + static_cast<int64_t>(h) * K;
  const __nv_bfloat16* gp = g + (n * lanes + static_cast<int64_t>(h) * K) * 4 * D;
  const int total = K * vpr;

  if constexpr (V == kCopy) {
    uint4 first = make_uint4(0u, 0u, 0u, 0u);
    for (int vi = lane; vi < total; vi += 32) {
      const uint4 raw = load_piece_kept(gp + static_cast<int64_t>(vi) * N);
      if (vi == lane) first = raw;
    }
    // pieces 0 .. D/N - 1 of the group's first row are its first D values
    if (lane < D / N) {
      const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&first);
      float* op = out + row * D + lane * N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(hp[i]);
        op[2 * i] = f.x;
        op[2 * i + 1] = f.y;
      }
    }
    return;
  }

  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int vi = lane; vi < total; vi += 32) {
    const uint4 raw = load_piece(gp + static_cast<int64_t>(vi) * N);
    const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&raw);
    if constexpr (V == kW16) {
      const __nv_bfloat162 w2x = __float2bfloat162_rn(w[vi / vpr]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(__hmul2(hp[i], w2x));
        acc[2 * i] += f.x;
        acc[2 * i + 1] += f.y;
      }
    } else {
      const float wj = V == kW32 ? w[vi / vpr] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(hp[i]);
        acc[2 * i] += wj * f.x;
        acc[2 * i + 1] += wj * f.y;
      }
    }
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

template <int V>
int launch(const void* g, const float* w0, const float* w1, const float* w2,
           const float* w3, float* out, int64_t n_rows, int lanes, int K, int D,
           cudaStream_t stream) {
  const int64_t blocks = (n_rows * 32 + kThreads - 1) / kThreads;
  lab_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g), w0, w1, w2, w3, out, n_rows, lanes,
      K, D);
  return cudaGetLastError();
}

}  // namespace

// g [nq*lanes, 4*D] bfloat16 contiguous; w0..w3 [nq, lanes] float contiguous
// (read by w32 and w16 only); out [nq*(lanes/K), D] float contiguous; variant
// 0 copy, 1 seg, 2 w32, 3 w16. Returns the CUDA error code of the launch, -1
// for a shape or variant that has no kernel.
extern "C" int probe_msda_lab(const void* g, const float* w0, const float* w1,
                              const float* w2, const float* w3, float* out,
                              int64_t nq, int lanes, int K, int D, int variant,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpr = 4 * D / N;
  if (D % N || vpr < 1 || vpr > 32 || 32 % vpr || K < 1 || lanes % K) return -1;
  const int64_t n_rows = nq * (lanes / K);
  if (n_rows == 0) return 0;
  switch (variant) {
    case kCopy: return launch<kCopy>(g, w0, w1, w2, w3, out, n_rows, lanes, K, D, s);
    case kSeg: return launch<kSeg>(g, w0, w1, w2, w3, out, n_rows, lanes, K, D, s);
    case kW32: return launch<kW32>(g, w0, w1, w2, w3, out, n_rows, lanes, K, D, s);
    case kW16: return launch<kW16>(g, w0, w1, w2, w3, out, n_rows, lanes, K, D, s);
    default: return -1;
  }
}
