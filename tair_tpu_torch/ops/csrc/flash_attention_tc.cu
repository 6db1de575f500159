// Flash attention forward on the tensor cores of Hopper (sm_90a), bfloat16,
// plain C interface.
//
// Replaces the TPU kernel tair_tpu/ops/flash_attention.py::_flash_kernel
// (driven by _flash_forward) for bfloat16 inputs with head widths 16, 32, 64
// and 128: softmax(q k^T * scale) v with an online softmax, outputs O (bf16)
// and the per-row logsumexp (float, natural log), the same function as
// flash_attention.cu, which keeps float32 inputs and D = 512.
//
// Bound on this card: operations. A call does 4*Tq*Tk*D flops per (batch,
// head) over a few Tq*D values, so the logits stay on chip and the products
// must run on the tensor cores, the only unit near the card's bf16 rate.
//
// Design: FlashAttention-2 on mma.sync m16n8k16 (bf16 operands, float
// accumulators). One block of 4 warps per (batch*head, 64 queries); each warp
// owns 16 query rows. The query tile is copied to shared memory once and kept
// in registers as A fragments. Tiles of 64 keys of K and V go through a
// two-stage cp.async ring in bf16, so the next tile's copy overlaps this
// tile's products. S = Q K^T takes K by ldmatrix; the scale is applied to the
// float accumulator in log2 units and the online softmax (row max by quad
// shuffles, exp2) runs in registers. The accumulator fragments of P are the A
// fragments of P V (tensor_core.cuh), so P never touches shared memory; V is
// read by ldmatrix.trans. P is split into two bf16 terms (hi + lo) and P V is
// two products: one bf16 P costs 2^-9 of the typical |O| on every output,
// which fails the elementwise tolerance of outputs near 0 at 77 keys. Shared
// rows carry 16 bytes of padding, so ldmatrix is free of bank conflicts. Keys
// past Tk get a finite -1e30 before the max (p = 0, never NaN); rows past Tq
// are loaded as zeros and not stored. The [B, T, H, D] strides are taken as
// given: rows must be 16-byte aligned, nothing is padded or copied outside.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // queries per block
constexpr int kBK = 64;           // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;  // row pitch of a shared tile, in elements
  static constexpr int Q_ELEMS = kBQ * LD;
  static constexpr int KV_ELEMS = kBK * LD;
  static constexpr int SMEM_BYTES =
      (Q_ELEMS + 4 * KV_ELEMS) * static_cast<int>(sizeof(bf16));
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int Tq, int Tk,
                    int64_t q_sb, int64_t q_st, int64_t q_sh,
                    int64_t k_sb, int64_t k_st, int64_t k_sh,
                    int64_t v_sb, int64_t v_st, int64_t v_sh, float scale) {
  using C = Cfg<D>;
  constexpr int NT = kBK / 8;  // 8-key tiles of the logits
  constexpr int ND = D / 8;    // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + C::Q_ELEMS;       // two stages
  bf16* Vs = Ks + 2 * C::KV_ELEMS;  // two stages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qp = q + b * q_sb + h * q_sh + static_cast<int64_t>(q0) * q_st;
  const bf16* kp = k + b * k_sb + h * k_sh;
  const bf16* vp = v + b * v_sb + h * v_sh;
  const int n_tiles = (Tk + kBK - 1) / kBK;

  auto load_kv = [&](int t) {
    const int stage = t & 1;
    const int valid = min(kBK, Tk - t * kBK);
    const int64_t row = static_cast<int64_t>(t) * kBK;
    tc::load_rows_async(Ks + stage * C::KV_ELEMS, C::LD, kp + row * k_st, k_st, kBK,
                        valid, D, kThreads);
    tc::load_rows_async(Vs + stage * C::KV_ELEMS, C::LD, vp + row * v_st, v_st, kBK,
                        valid, D, kThreads);
  };
  tc::load_rows_async(Qs, C::LD, qp, q_st, kBQ, min(kBQ, Tq - q0), D, kThreads);
  load_kv(0);
  tc::cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows lane/4 and lane/4 + 8 of the warp's 16: running max (log2 units) and
  // this thread's part of the running sum (its quad holds the rest)
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);  // into the stage every warp left at the end of tile t-1
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, Q) is in shared memory
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::ldmatrix_x4(qf[kk], tc::a_rows(Qs, C::LD, warp * 16, kk * 16, lane));
    }
    const bf16* Kt = Ks + (t & 1) * C::KV_ELEMS;
    const bf16* Vt = Vs + (t & 1) * C::KV_ELEMS;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, tc::b_rows(Kt, C::LD, np * 16, kk * 16, lane));
        tc::mma(s[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale to log2 units, mask keys past Tk, online softmax
    const int key0 = t * kBK + 2 * (lane & 3);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = key0 + j * 8 + e < Tk;
        s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
        s[j][2 + e] = ok ? s[j][2 + e] * scale_log2 : kNegInf;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }

    // acc += P V, P as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      tc::a_from_c(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, tc::a_rows(Vt, C::LD, kk * 16, dp * 16, lane));
        tc::mma(acc[2 * dp], ph, vb[0], vb[1]);
        tc::mma(acc[2 * dp + 1], ph, vb[2], vb[3]);
        tc::mma(acc[2 * dp], pl, vb[0], vb[1]);
        tc::mma(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: O = acc / l, lse = m + log(l) in natural-log units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * i;
    if (row >= Tq) continue;
    const float l = l_run[i];
    const float inv = 1.f / l;
    bf16* op = o + ((static_cast<int64_t>(b) * Tq + row) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    if ((lane & 3) == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Tq + row] = m_run[i] * kLn2 + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int H, int Tq, int Tk, const int64_t* st, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, Tq, Tk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k and v [B, Tk, H, D], bfloat16, with unit stride along D,
// rows 16-byte aligned and the element strides (batch, token, head) of q, k, v
// in strides[0..8]; o [B, Tq, H, D] bfloat16 contiguous; lse [B, H, Tq] float.
// Returns the CUDA error code of the launch (0 on success), -1 for a head
// width that has no kernel.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k, const void* v,
                                      void* o, float* lse, int B, int H, int Tq,
                                      int Tk, int D, const int64_t* strides,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, s);
    case 32: return launch<32>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, Tq, Tk, strides, scale, s);
    default: return -1;
  }
}
