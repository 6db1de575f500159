// int8 implicit-GEMM convolution with the w8a8 rescale in its epilogue (Q1 of
// the w8a8 serving path) for Hopper (sm_90a), plain C interface.
//
// No Pallas kernel stands behind it: in tair_tpu/ops/quant.py (w8a8_conv,
// w8a8_dot_general) XLA lowers the s8 x s8 -> s32 conv_general_dilated and
// dot_general itself. PyTorch has no int8 convolution on CUDA, so the port
// writes its own. Function, with x8 [B, H, W, Cp] and w8 [O, KH, KW, Cp] int8
// (channels innermost, Cp a multiple of 16, zero in the padded channels):
//   acc[b, oy, ox, o] = sum_{ky, kx, c} x8[b, oy*s - p + ky, ox*s - p + kx, c] * w8[o, ky, kx, c]
//                       (zero outside the image), in int32
//   out[b, oy, ox, o] = T(float(acc) * (wscale[o] * xscale))        T = float or bf16
//   out += bias[o]     in T, after the rounding to T (Flax adds the bias after the product)
// with xscale = stats[1], read on the device. A dense layer is the 1 x 1 case
// over its tokens (B = tokens, H = W = 1).
//
// Bound on this card: operations at the UNet's wide sites (int8 tensor cores,
// 1,979 TOP/s dense), bytes at the narrow 1 x 1 ones. This first design is
// simple and exact, not fast: 64 x 64 output tiles, 4 warps of 32 x 32, K in
// 64-byte steps staged in shared memory by cp.async (two stages, zero-filled
// outside the image, past K and past O), mma.sync m16n8k32 s8 x s8 -> s32. The
// inner blocks at 512 x 512 have few output rows (M = 64 at 8 x 8 with K =
// 11,520), so when the tiles do not fill the card K is split over blocks
// (gridDim.z): each split writes its int32 partial sums and a second kernel
// adds them and applies the epilogue. Integer sums do not depend on their
// order, so every split gives the same bits. The epilogue uses __fmul_rn /
// __fadd_rn and rounds to T before the bias add, so nvcc cannot contract the
// product and the add into one FMA: the output equals the plain version's
// (float64 im2col product, ops/quant.py) bit for bit. wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int kThreads = 128;
constexpr int kPitch = BK + 16;  // bytes a shared row: 16-byte aligned, fragment reads conflict-free

struct Geometry {
  int B, H, W, Cp, O, KH, KW, stride, pad, Ho, Wo, M, K;
};

__device__ inline void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ inline T round_to(float x);
template <>
__device__ inline float round_to<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 round_to<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__device__ inline void store_out(T* out, const T* bias, const float* wscale, float xscale,
                                 int64_t m, int n, int O, int acc) {
  const float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(wscale[n], xscale));
  T v = round_to<T>(y);
  if (bias != nullptr) v = round_to<T>(__fadd_rn(to_float(v), to_float(bias[n])));
  out[m * O + n] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ w8,
                 const float* __restrict__ wscale, const float* __restrict__ stats,
                 const T* __restrict__ bias, T* __restrict__ out, int32_t* __restrict__ partial,
                 Geometry g, int steps_per_split) {
  __shared__ __align__(16) int8_t As[2][BM * kPitch];
  __shared__ __align__(16) int8_t Bs[2][BN * kPitch];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps = (g.K + BK - 1) / BK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(steps, s_begin + steps_per_split);

  // each thread stages the same 16-byte piece of two A rows and two B rows
  const int piece = tid & 3;
  int a_b[2], a_iy[2], a_ix[2];
  bool a_ok[2], b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid >> 2) + 32 * i;
    const int m = m0 + r;
    a_ok[i] = m < g.M;
    const int mm = a_ok[i] ? m : 0;
    const int hw = g.Ho * g.Wo;
    const int b = mm / hw;
    const int rem = mm - b * hw;
    const int oy = rem / g.Wo;
    a_b[i] = b;
    a_iy[i] = oy * g.stride - g.pad;
    a_ix[i] = (rem - oy * g.Wo) * g.stride - g.pad;
    b_ok[i] = n0 + r < g.O;
  }

  auto load_stage = [&](int stage, int step) {
    const int k = step * BK + piece * 16;
    const bool k_ok = k < g.K;
    const int tap = k_ok ? k / g.Cp : 0;
    const int c = k_ok ? k - tap * g.Cp : 0;
    const int ky = tap / g.KW;
    const int kx = tap - ky * g.KW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 32 * i;
      const int iy = a_iy[i] + ky, ix = a_ix[i] + kx;
      const bool ok = a_ok[i] && k_ok && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const int8_t* src =
          ok ? x8 + ((static_cast<int64_t>(a_b[i]) * g.H + iy) * g.W + ix) * g.Cp + c : x8;
      tc::cp_async_16(&As[stage][r * kPitch + piece * 16], src, ok);
      const bool wok = b_ok[i] && k_ok;
      const int8_t* wsrc = wok ? w8 + static_cast<int64_t>(n0 + r) * g.K + k : w8;
      tc::cp_async_16(&Bs[stage][r * kPitch + piece * 16], wsrc, wok);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  if (s_begin < s_end) load_stage(0, s_begin);
  tc::cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int cur = (s - s_begin) & 1;
    if (s + 1 < s_end) load_stage(cur ^ 1, s + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int8_t* A = As[cur];
    const int8_t* Bt = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = A + (wm + mt * 16 + gq) * kPitch + kk + tq * 4;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * kPitch);
        a[mt][2] = ld32(p + 16);
        a[mt][3] = ld32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* q = Bt + (wn + nt * 8 + gq) * kPitch + kk + tq * 4;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  const float xscale = stats[1];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mt * 16 + gq + (e >> 1) * 8;
        const int n = n0 + wn + nt * 8 + tq * 2 + (e & 1);
        if (m >= g.M || n >= g.O) continue;
        if (partial != nullptr)
          partial[(static_cast<int64_t>(blockIdx.z) * g.M + m) * g.O + n] = acc[mt][nt][e];
        else
          store_out(out, bias, wscale, xscale, m, n, g.O, acc[mt][nt][e]);
      }
}

template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const int32_t* __restrict__ partial, int splits, int64_t mn, int O,
                     const float* __restrict__ wscale, const float* __restrict__ stats,
                     const T* __restrict__ bias, T* __restrict__ out) {
  const float xscale = stats[1];
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; i < mn;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += partial[s * mn + i];
    store_out(out, bias, wscale, xscale, i / O, static_cast<int>(i % O), O, acc);
  }
}

template <typename T>
int launch(const int8_t* x8, const int8_t* w8, const float* wscale, const float* stats,
           const T* bias, T* out, int32_t* workspace, int splits, const Geometry& g,
           cudaStream_t stream) {
  const int steps = (g.K + BK - 1) / BK;
  const int per = (steps + splits - 1) / splits;
  const dim3 grid((g.M + BM - 1) / BM, (g.O + BN - 1) / BN, splits);
  int8_conv_kernel<T><<<grid, kThreads, 0, stream>>>(x8, w8, wscale, stats, bias, out,
                                                     splits > 1 ? workspace : nullptr, g, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t mn = static_cast<int64_t>(g.M) * g.O;
  const int64_t want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  splitk_reduce_kernel<T><<<blocks, 256, 0, stream>>>(workspace, splits, mn, g.O, wscale, stats,
                                                      bias, out);
  return cudaGetLastError();
}

}  // namespace

// x8 [B, H, W, Cp], w8 [O, KH, KW, Cp] int8 (16-byte aligned, Cp % 16 == 0);
// wscale [O] float32; stats [2] float32 (xscale at [1]); bias [O] in the output
// type when has_bias; out [B, Ho, Wo, O] float32 (out_dtype 0) or bfloat16 (1);
// workspace [splits, B*Ho*Wo, O] int32 when splits > 1. Returns 0, -1 for
// arguments the kernel does not take, or the CUDA error of a launch.
extern "C" int int8_conv_s8(const void* x8, const void* w8, const void* wscale,
                            const void* stats, const void* bias, int has_bias, void* out,
                            int out_dtype, void* workspace, int splits, int B, int H, int W,
                            int Cp, int O, int KH, int KW, int stride, int pad, int Ho, int Wo,
                            void* stream) {
  if (B < 1 || H < 1 || W < 1 || O < 1 || KH < 1 || KW < 1 || stride < 1 || pad < 0) return -1;
  if (Cp < 16 || Cp % 16 || splits < 1 || (splits > 1 && workspace == nullptr)) return -1;
  if (Ho != (H + 2 * pad - KH) / stride + 1 || Wo != (W + 2 * pad - KW) / stride + 1) return -1;
  if (Ho < 1 || Wo < 1 || (has_bias && bias == nullptr)) return -1;
  if (reinterpret_cast<uintptr_t>(x8) % 16 || reinterpret_cast<uintptr_t>(w8) % 16) return -1;
  const int64_t m = static_cast<int64_t>(B) * Ho * Wo;
  const int64_t k = static_cast<int64_t>(KH) * KW * Cp;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL || (O + BN - 1) / BN > 65535 || splits > 65535)
    return -1;
  const Geometry g{B, H, W, Cp, O, KH, KW, stride, pad, Ho, Wo, static_cast<int>(m),
                   static_cast<int>(k)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(x8);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* ws = static_cast<const float*>(wscale);
  const float* st = static_cast<const float*>(stats);
  int32_t* part = static_cast<int32_t*>(workspace);
  if (out_dtype == 0)
    return launch(x, w, ws, st, has_bias ? static_cast<const float*>(bias) : nullptr,
                  static_cast<float*>(out), part, splits, g, s);
  if (out_dtype == 1)
    return launch(x, w, ws, st, has_bias ? static_cast<const __nv_bfloat16*>(bias) : nullptr,
                  static_cast<__nv_bfloat16*>(out), part, splits, g, s);
  return -1;
}
