// Flash attention dQ on the tensor cores of Hopper (sm_90a), bfloat16, plain C
// interface.
//
// Replaces the TPU kernel tair_tpu/ops/flash_attention.py::_flash_dq_kernel
// (driven by _flash_attention_bwd) for bfloat16 inputs with head widths 16,
// 32, 64 and 128. With P = exp(scale * q k^T - lse) rebuilt from the forward's
// logsumexp, dP = dO v^T and dS = P * (dP - delta) * scale (delta =
// rowsum(dO * O), both float [B, H, Tq] from the wrapper), it gives dQ = dS k;
// flash_attention_bwd.cu keeps float32.
//
// Bound on this card: operations. Three products of 2*Tq*Tk*D flops per
// (batch, head) over a few (Tq + Tk)*D values, so P and dS stay on chip and
// every product runs on the tensor cores.
//
// Design: the forward's (flash_attention_tc.cu) with one more product, on
// mma.sync m16n8k16, bf16 operands, float accumulators. One block of 4 warps
// per (batch*head, 64 queries); each warp owns 16 query rows. q and dO are
// copied to shared memory once and kept in registers as A fragments; tiles of
// BK keys of K and V go through a two-stage cp.async ring. S = q K^T and
// dP = dO V^T take K and V as B operands by ldmatrix; P and dS stay in float
// registers (lse in log2 units, lse and delta read once for the thread's two
// rows). dQ += dS K takes the accumulator fragments of dS as A fragments
// (tensor_core.cuh::a_from_c) and K by ldmatrix.trans, as the forward's P V
// takes V. dS enters as two bf16 terms (hi + lo), two products: one bf16 term
// fails the elementwise tolerance of elements near 0 (the CPU emulation in
// tests/test_torch_flash_attention.py). dQ is stored once in bf16: no atomics,
// deterministic. Keys past Tk get P = 0 (never NaN); rows past Tq are loaded as
// zeros, with lse = delta = 0, and are not stored. At D = 128 the key tiles
// are 32 wide, so the live fragments (q, dO, dQ, S, dP) fit the registers (228
// by ptxas, no spill). At D = 16 they are 32 wide too: with 64-key tiles ptxas
// spilled 4 bytes there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // queries per block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = (D == 16 || D == 128) ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 8;  // row pitch of a shared tile
  static constexpr int QT_ELEMS = kBQ * LD;
  static constexpr int KV_ELEMS = BK * LD;
  static constexpr int SMEM_BYTES =
      (2 * QT_ELEMS + 4 * KV_ELEMS) * static_cast<int>(sizeof(bf16));
};

struct Strides {
  int64_t q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, do_b, do_t, do_h;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dO,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int H, int Tq, int Tk, Strides st,
                   float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 8;  // 8-key tiles of S and dP
  constexpr int ND = D / 8;   // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + C::QT_ELEMS;
  bf16* Ks = dOs + C::QT_ELEMS;     // two stages
  bf16* Vs = Ks + 2 * C::KV_ELEMS;  // two stages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int q_valid = min(kBQ, Tq - q0);
  const bf16* qp = q + b * st.q_b + h * st.q_h + static_cast<int64_t>(q0) * st.q_t;
  const bf16* dop = dO + b * st.do_b + h * st.do_h + static_cast<int64_t>(q0) * st.do_t;
  const bf16* kp = k + b * st.k_b + h * st.k_h;
  const bf16* vp = v + b * st.v_b + h * st.v_h;
  const int n_tiles = (Tk + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const int stage = t & 1;
    const int valid = min(BK, Tk - t * BK);
    const int64_t row = static_cast<int64_t>(t) * BK;
    tc::load_rows_async(Ks + stage * C::KV_ELEMS, C::LD, kp + row * st.k_t, st.k_t, BK,
                        valid, D, kThreads);
    tc::load_rows_async(Vs + stage * C::KV_ELEMS, C::LD, vp + row * st.v_t, st.v_t, BK,
                        valid, D, kThreads);
  };
  tc::load_rows_async(Qs, C::LD, qp, st.q_t, kBQ, q_valid, D, kThreads);
  tc::load_rows_async(dOs, C::LD, dop, st.do_t, kBQ, q_valid, D, kThreads);
  load_kv(0);
  tc::cp_async_commit();

  // rows lane/4 and lane/4 + 8 of the warp's 16: lse (log2 units) and delta
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + q0 + r;
    l2[i] = r < q_valid ? lse[at] * kLog2e : 0.f;
    dl[i] = r < q_valid ? delta[at] : 0.f;
  }

  uint32_t qf[D / 16][4], of[D / 16][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);  // into the stage every warp left at the end of tile t-1
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, q and dO) is in shared memory
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        tc::ldmatrix_x4(qf[kk], tc::a_rows(Qs, C::LD, warp * 16, kk * 16, lane));
        tc::ldmatrix_x4(of[kk], tc::a_rows(dOs, C::LD, warp * 16, kk * 16, lane));
      }
    }
    const bf16* Kt = Ks + (t & 1) * C::KV_ELEMS;
    const bf16* Vt = Vs + (t & 1) * C::KV_ELEMS;

    // S = q K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, tc::b_rows(Kt, C::LD, np * 16, kk * 16, lane));
        tc::mma(s[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        tc::ldmatrix_x4(vb, tc::b_rows(Vt, C::LD, np * 16, kk * 16, lane));
        tc::mma(dp[2 * np], of[kk], vb[0], vb[1]);
        tc::mma(dp[2 * np + 1], of[kk], vb[2], vb[3]);
      }
    }

    // P = exp(S * scale - lse), dS = P * (dP - delta) * scale; keys past Tk
    // give P = 0
    const int key0 = t * BK + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = key0 + j * 8 + (e & 1) < Tk;
        const float p = ok ? exp2f(s[j][e] * scale_log2 - l2[i]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[i]) * scale;
      }

    // dQ += dS K, dS as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      tc::a_from_c(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kb[4];
        tc::ldmatrix_x4_trans(kb, tc::a_rows(Kt, C::LD, kk * 16, dd * 16, lane));
        tc::mma(acc[2 * dd], sh, kb[0], kb[1]);
        tc::mma(acc[2 * dd + 1], sh, kb[2], kb[3]);
        tc::mma(acc[2 * dd], sl, kb[0], kb[1]);
        tc::mma(acc[2 * dd + 1], sl, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // rows lane/4 and lane/4 + 8 of the warp's 16, columns 2*(lane%4) + {0, 1}
  // of every 8-column tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * i;
    if (row >= Tq) continue;
    bf16* op = dq + ((static_cast<int64_t>(b) * Tq + row) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const float* lse, const float* delta, void* dq, int B, int H, int Tq, int Tk,
           const int64_t* s, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
      static_cast<bf16*>(dq), H, Tq, Tk, st, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dO [B, Tq, H, D] and k, v [B, Tk, H, D], bfloat16, with unit stride along
// D, rows 16-byte aligned and the element strides (batch, token, head) of q,
// k, v, dO in strides[0..11]; lse, delta [B, H, Tq] float contiguous; dq
// [B, Tq, H, D] bfloat16 contiguous. Returns the CUDA error code of the launch
// (0 on success), -1 for a head width that has no kernel.
extern "C" int flash_attention_dq_tc(const void* q, const void* k, const void* v,
                                     const void* dO, const float* lse,
                                     const float* delta, void* dq, int B, int H,
                                     int Tq, int Tk, int D, const int64_t* strides,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, dO, lse, delta, dq, B, H, Tq, Tk, strides, scale, s);
    case 32: return launch<32>(q, k, v, dO, lse, delta, dq, B, H, Tq, Tk, strides, scale, s);
    case 64: return launch<64>(q, k, v, dO, lse, delta, dq, B, H, Tq, Tk, strides, scale, s);
    case 128: return launch<128>(q, k, v, dO, lse, delta, dq, B, H, Tq, Tk, strides, scale, s);
    default: return -1;
  }
}
