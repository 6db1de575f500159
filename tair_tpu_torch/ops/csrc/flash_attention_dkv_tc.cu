// Flash attention dK and dV on the tensor cores of Hopper (sm_90a), bfloat16,
// plain C interface.
//
// Replaces the TPU kernel tair_tpu/ops/flash_attention.py::_flash_dkv_kernel
// (driven by _flash_attention_bwd) for bfloat16 inputs with head widths 16,
// 32, 64 and 128. With P = exp(scale * q k^T - lse) rebuilt from the forward's
// logsumexp, dP = dO v^T and dS = P * (dP - delta) * scale (delta =
// rowsum(dO * O), both float [B, H, Tq] from the wrapper), it gives
// dK = dS^T q and dV = P^T dO; flash_attention_bwd.cu keeps float32.
//
// Bound on this card: operations (four products of 2*Tq*Tk*D flops per
// (batch, head) over a few (Tq + Tk)*D values), so P and dS stay on chip and
// every product runs on the tensor cores. At 77 keys (cross-attention) a grid
// over key tiles alone has two blocks a head: there the bound is the launch,
// and what matters is that the card is filled.
//
// Design: mma.sync m16n8k16, bf16 operands, float accumulators. One block of
// 4 warps owns 64 keys (16 a warp; K and V stay in shared memory in bf16) and
// streams tiles of BQ queries of q and dO, with their lse and delta, through a
// two-stage cp.async ring. Per tile a warp forms S^T = K q^T and dP^T = V dO^T
// (q and dO by ldmatrix, no transpose needed), turns them into P^T and dS^T in
// float registers, and adds P^T dO to dV and dS^T q to dK, with P^T and dS^T
// as A fragments straight from the accumulators and dO, q by ldmatrix.trans.
// P^T and dS^T are split into two bf16 terms (hi + lo), two products each: one
// bf16 term costs 2^-9 of a typical gradient on every element, which fails
// the elementwise tolerance of elements near 0. Query rows past Tq are loaded
// as zeros (lse and delta too) and masked to P = 0; key rows past Tk only
// reach their own rows of dK and dV, which are never stored.
//
// Query split: the grid's z dimension cuts the queries into `splits` chunks of
// `chunk` queries (a multiple of 64) chosen by the wrapper so that short key
// sequences still fill the card. With one chunk the block stores dK and dV in
// bf16; with more, each block stores float partials in a workspace
// [2, splits, B, Tk, H, D] and a second kernel adds them in chunk order and
// rounds once. No atomics: dK and dV are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 16 * kWarps;  // keys per block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BQ = (D > 64) ? 16 : 64;  // queries per streamed tile
  static constexpr int LD = D + 8;               // row pitch of a shared tile
  static constexpr int KV_ELEMS = kBK * LD;
  static constexpr int QT_ELEMS = BQ * LD;
  static constexpr int SMEM_BYTES =
      (2 * KV_ELEMS + 4 * QT_ELEMS) * static_cast<int>(sizeof(bf16)) +
      4 * BQ * static_cast<int>(sizeof(float));
};

struct Strides {
  int64_t q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, do_b, do_t, do_h;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ ws, int H, int Tq, int Tk, int chunk,
                    Strides st, float scale) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  constexpr int NQ = BQ / 8;  // 8-query tiles of S^T and dP^T
  constexpr int ND = D / 8;   // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + C::KV_ELEMS;
  bf16* Qs = Vs + C::KV_ELEMS;       // two stages
  bf16* dOs = Qs + 2 * C::QT_ELEMS;  // two stages
  float* stats = reinterpret_cast<float*>(dOs + 2 * C::QT_ELEMS);  // [stage][lse | delta][BQ]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kBK;
  const int q_begin = blockIdx.z * chunk;
  const int q_end = min(Tq, q_begin + chunk);
  const int n_tiles = (q_end - q_begin + BQ - 1) / BQ;

  const bf16* kp = k + b * st.k_b + h * st.k_h + static_cast<int64_t>(k0) * st.k_t;
  const bf16* vp = v + b * st.v_b + h * st.v_h + static_cast<int64_t>(k0) * st.v_t;
  const bf16* qp = q + b * st.q_b + h * st.q_h;
  const bf16* dop = dO + b * st.do_b + h * st.do_h;
  const float* lsep = lse + (static_cast<int64_t>(b) * H + h) * Tq;
  const float* deltap = delta + (static_cast<int64_t>(b) * H + h) * Tq;

  auto load_q = [&](int t) {
    const int stage = t & 1;
    const int r0 = q_begin + t * BQ;
    const int valid = min(BQ, q_end - r0);
    tc::load_rows_async(Qs + stage * C::QT_ELEMS, C::LD, qp + static_cast<int64_t>(r0) * st.q_t,
                        st.q_t, BQ, valid, D, kThreads);
    tc::load_rows_async(dOs + stage * C::QT_ELEMS, C::LD,
                        dop + static_cast<int64_t>(r0) * st.do_t, st.do_t, BQ, valid, D,
                        kThreads);
    const int i = threadIdx.x;
    if (i < 2 * BQ) {
      const int r = i % BQ;
      const float* src = (i < BQ ? lsep : deltap) + r0;
      tc::cp_async_4(stats + stage * 2 * BQ + i, src + (r < valid ? r : 0), r < valid);
    }
  };
  const int k_valid = min(kBK, Tk - k0);
  tc::load_rows_async(Ks, C::LD, kp, st.k_t, kBK, k_valid, D, kThreads);
  tc::load_rows_async(Vs, C::LD, vp, st.v_t, kBK, k_valid, D, kThreads);
  if (n_tiles > 0) load_q(0);
  tc::cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[j][e] = 0.f;
      acc_v[j][e] = 0.f;
    }
  const float scale_log2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_q(t + 1);  // into the stage every warp left at the end of tile t-1
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, K and V) is in shared memory
    const bf16* Qt = Qs + (t & 1) * C::QT_ELEMS;
    const bf16* dOt = dOs + (t & 1) * C::QT_ELEMS;
    const float* lse_t = stats + (t & 1) * 2 * BQ;
    const float* delta_t = lse_t + BQ;
    const int q_valid = min(BQ, q_end - (q_begin + t * BQ));

    // S^T = K q^T and dP^T = V dO^T for the warp's 16 keys
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      tc::ldmatrix_x4(ka, tc::a_rows(Ks, C::LD, warp * 16, kk * 16, lane));
      tc::ldmatrix_x4(va, tc::a_rows(Vs, C::LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qb[4], ob[4];
        tc::ldmatrix_x4(qb, tc::b_rows(Qt, C::LD, np * 16, kk * 16, lane));
        tc::mma(s[2 * np], ka, qb[0], qb[1]);
        tc::mma(s[2 * np + 1], ka, qb[2], qb[3]);
        tc::ldmatrix_x4(ob, tc::b_rows(dOt, C::LD, np * 16, kk * 16, lane));
        tc::mma(dp[2 * np], va, ob[0], ob[1]);
        tc::mma(dp[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P^T = exp(S^T * scale - lse[q]), dS^T = P^T * (dP^T - delta[q]) * scale
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = j * 8 + 2 * (lane & 3) + e;
        const float l2 = lse_t[qi] * kLog2e;
        const float dl = delta_t[qi];
        const bool ok = qi < q_valid;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = ok ? exp2f(s[j][2 * r + e] * scale_log2 - l2) : 0.f;
          s[j][2 * r + e] = p;
          dp[j][2 * r + e] = p * (dp[j][2 * r + e] - dl) * scale;
        }
      }

    // dV += P^T dO, dK += dS^T q, each as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      tc::a_from_c(s[2 * kk], s[2 * kk + 1], ph, pl);
      tc::a_from_c(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, tc::a_rows(dOt, C::LD, kk * 16, dd * 16, lane));
        tc::mma(acc_v[2 * dd], ph, ob[0], ob[1]);
        tc::mma(acc_v[2 * dd + 1], ph, ob[2], ob[3]);
        tc::mma(acc_v[2 * dd], pl, ob[0], ob[1]);
        tc::mma(acc_v[2 * dd + 1], pl, ob[2], ob[3]);
        tc::ldmatrix_x4_trans(qb, tc::a_rows(Qt, C::LD, kk * 16, dd * 16, lane));
        tc::mma(acc_k[2 * dd], sh, qb[0], qb[1]);
        tc::mma(acc_k[2 * dd + 1], sh, qb[2], qb[3]);
        tc::mma(acc_k[2 * dd], sl, qb[0], qb[1]);
        tc::mma(acc_k[2 * dd + 1], sl, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  tc::cp_async_wait<0>();  // an empty chunk still issued K and V

  // rows lane/4 and lane/4 + 8 of the warp's keys, columns 2*(lane%4) + {0, 1}
  // of every 8-column tile
  const int64_t per_split = static_cast<int64_t>(gridDim.y) * Tk * D;  // B*H*Tk*D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + (lane >> 2) + 8 * i;
    if (key >= Tk) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Tk + key) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (ws == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + j * 8) =
            __floats2bfloat162_rn(acc_k[j][2 * i], acc_k[j][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + j * 8) =
            __floats2bfloat162_rn(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
      } else {
        float* wk = ws + blockIdx.z * per_split + at + j * 8;
        float* wv = wk + gridDim.z * per_split;
        *reinterpret_cast<float2*>(wk) = make_float2(acc_k[j][2 * i], acc_k[j][2 * i + 1]);
        *reinterpret_cast<float2*>(wv) = make_float2(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
      }
    }
  }
}

// out[i] = sum over s of ws[s][i], s in order, for i < n (a multiple of 4);
// blockIdx.y picks dK (0) or dV (1)
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ ws, int splits, int64_t n,
                    bf16* __restrict__ dk, bf16* __restrict__ dv) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float* src = ws + blockIdx.y * splits * n + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* out = (blockIdx.y == 0 ? dk : dv) + i;
  reinterpret_cast<__nv_bfloat162*>(out)[0] = __floats2bfloat162_rn(acc.x, acc.y);
  reinterpret_cast<__nv_bfloat162*>(out)[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const float* lse, const float* delta, void* dk, void* dv, float* ws,
           int B, int H, int Tq, int Tk, const int64_t* s, float scale, int splits,
           int chunk, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  const dim3 grid((Tk + kBK - 1) / kBK, B * H, splits);
  kern<<<grid, kThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), splits > 1 ? ws : nullptr, H,
      Tq, Tk, chunk, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n = static_cast<int64_t>(B) * Tk * H * D;
  const dim3 sum_grid(static_cast<unsigned>((n / 4 + 255) / 256), 2);
  sum_partials_kernel<<<sum_grid, 256, 0, stream>>>(ws, splits, n, static_cast<bf16*>(dk),
                                                    static_cast<bf16*>(dv));
  return cudaGetLastError();
}

}  // namespace

// q, dO [B, Tq, H, D] and k, v [B, Tk, H, D], bfloat16, with unit stride along
// D, rows 16-byte aligned and the element strides (batch, token, head) of q,
// k, v, dO in strides[0..11]; lse, delta [B, H, Tq] float contiguous; dk, dv
// [B, Tk, H, D] bfloat16 contiguous. The queries are cut into `splits` chunks
// of `chunk` queries (a multiple of 64; splits * chunk >= Tq); with splits > 1,
// ws is a float workspace of 2 * splits * B * Tk * H * D values. Returns the
// CUDA error code of the launches (0 on success), -1 for a head width that
// has no kernel.
extern "C" int flash_attention_dkv_tc(const void* q, const void* k, const void* v,
                                      const void* dO, const float* lse,
                                      const float* delta, void* dk, void* dv,
                                      float* ws, int B, int H, int Tq, int Tk, int D,
                                      const int64_t* strides, float scale, int splits,
                                      int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV_TC_LAUNCH(DD)                                                           \
  return launch<DD>(q, k, v, dO, lse, delta, dk, dv, ws, B, H, Tq, Tk, strides, scale, \
                    splits, chunk, s)
  switch (D) {
    case 16: DKV_TC_LAUNCH(16);
    case 32: DKV_TC_LAUNCH(32);
    case 64: DKV_TC_LAUNCH(64);
    case 128: DKV_TC_LAUNCH(128);
    default: return -1;
  }
#undef DKV_TC_LAUNCH
}
