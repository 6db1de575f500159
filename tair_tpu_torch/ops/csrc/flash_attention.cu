// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tair_tpu/ops/flash_attention.py::_flash_kernel
// (driven by _flash_forward): softmax(q k^T * scale) v with an online softmax,
// float accumulation whatever the input type, outputs O (input type) and the
// per-row logsumexp (float).
//
// Bound on this card: operations. One call does 4*Tq*Tk*D flops per
// (batch, head) over Tq*D + 2*Tk*D + Tq*D values, far above the card's
// flops-per-byte balance at every shape the restore loop uses, so the [Tq, Tk]
// logits must never reach device memory and the products must stay on chip.
//
// Design: one block of 256 threads per (batch*head, tile of BQ queries). The
// scaled query tile stays in shared memory for the whole block; a loop over
// 64-key tiles takes the place of the TPU grid's sequential key dimension. For
// each key tile the block (1) forms the BQ x 64 logits as a register-tiled
// product over D (K staged in shared memory in chunks of at most 64 columns),
// (2) masks keys past Tk, updates the running row max and normaliser with
// 16-lane shuffles and writes the probabilities to shared memory, (3) adds
// P v into the float accumulators (V staged in row chunks through the same
// buffer as K). D = 512 (the VAE mid block) does not fit a one-row-per-thread
// design: there BQ is 32 and each thread keeps a 2 x 32 accumulator while K
// and V stream through in chunks. Ragged Tq and Tk are masked here, nothing is
// padded outside, and the [B, T, H, D] strides are taken as given, so no
// folded copy is made. Products are plain FMA: no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "vec_load.cuh"

namespace {

using flash::kBK;
using flash::kThreads;
using flash::load_tile;
constexpr float kNegInf = -1e30f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D>
struct Cfg {
  static constexpr int BQ = (D > 128) ? 32 : 64;  // queries per block
  static constexpr int RQ = BQ / 16;              // query rows per thread
  static constexpr int CK = kBK / 16;             // logit columns per thread
  static constexpr int DC = (D < 64) ? D : 64;    // K columns staged at once
  static constexpr int VR = (D <= 64) ? 64 : 4096 / D;  // V rows staged at once
  static constexpr int VEC = (D >= 64) ? 4 : D / 16;    // output columns per vector
  static constexpr int NCV = D / (16 * VEC);            // vectors per thread
  static constexpr int LDQ = D + 4;
  static constexpr int LDK = DC + 4;
  static constexpr int LDV = D + 4;
  static constexpr int LDP = kBK + 4;
  static constexpr int KV_FLOATS = cmax(kBK * LDK, VR * LDV);
  static constexpr int SMEM_BYTES =
      (BQ * LDQ + KV_FLOATS + BQ * LDP) * static_cast<int>(sizeof(float));
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 int64_t q_sb, int64_t q_st, int64_t q_sh,
                 int64_t k_sb, int64_t k_st, int64_t k_sh,
                 int64_t v_sb, int64_t v_st, int64_t v_sh, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + C::BQ * C::LDQ;
  float* Ps = KVs + C::KV_FLOATS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // logit / output column group
  const int ty = tid >> 4;  // query row group
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * C::BQ;

  const T* qp = q + b * q_sb + h * q_sh + static_cast<int64_t>(q0) * q_st;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  const int q_valid = min(C::BQ, Tq - q0);
  load_tile<T>(Qs, C::LDQ, qp, q_st, C::BQ, q_valid, D, scale);

  float acc[C::RQ][C::NCV][C::VEC];
  float m_run[C::RQ];
  float l_run[C::RQ];
#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) acc[i][j][e] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    const int k_valid = min(kBK, Tk - k0);

    // (1) logits s = (q * scale) k^T for this key tile
    float s[C::RQ][C::CK];
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
#pragma unroll
      for (int j = 0; j < C::CK; ++j) s[i][j] = 0.f;

    for (int dc0 = 0; dc0 < D; dc0 += C::DC) {
      __syncthreads();  // earlier readers of KVs (and the Q load) are done
      load_tile<T>(KVs, C::LDK, kp + static_cast<int64_t>(k0) * k_st + dc0,
                   k_st, kBK, k_valid, C::DC, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < C::DC; dd += 4) {
        float4 qv[C::RQ];
        float4 kv[C::CK];
#pragma unroll
        for (int i = 0; i < C::RQ; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              &Qs[(ty * C::RQ + i) * C::LDQ + dc0 + dd]);
#pragma unroll
        for (int j = 0; j < C::CK; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              &KVs[(tx + 16 * j) * C::LDK + dd]);
#pragma unroll
        for (int i = 0; i < C::RQ; ++i)
#pragma unroll
          for (int j = 0; j < C::CK; ++j)
            s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                       qv[i].z * kv[j].z + qv[i].w * kv[j].w;
      }
    }

    // (2) mask, online softmax update, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < C::RQ; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::CK; ++j) {
        if (tx + 16 * j >= k_valid) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * C::RQ + i) * C::LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::NCV; ++j)
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) acc[i][j][e] *= alpha;
    }

    // (3) acc += P v, V staged VR rows at a time
    for (int r0 = 0; r0 < kBK; r0 += C::VR) {
      if (r0 >= k_valid) break;  // same for the whole block
      __syncthreads();  // logits done with KVs; P visible
      load_tile<T>(KVs, C::LDV, vp + static_cast<int64_t>(k0 + r0) * v_st,
                   v_st, C::VR, k_valid - r0, D, 1.f);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < C::VR; kk += 4) {
        float pv[C::RQ][4];
#pragma unroll
        for (int i = 0; i < C::RQ; ++i) {
          const float4 t = *reinterpret_cast<const float4*>(
              &Ps[(ty * C::RQ + i) * C::LDP + r0 + kk]);
          pv[i][0] = t.x;
          pv[i][1] = t.y;
          pv[i][2] = t.z;
          pv[i][3] = t.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < C::NCV; ++j) {
            const float* vrow = &KVs[(kk + u) * C::LDV + (j * 16 + tx) * C::VEC];
#pragma unroll
            for (int e = 0; e < C::VEC; ++e) {
              const float vv = vrow[e];
#pragma unroll
              for (int i = 0; i < C::RQ; ++i) acc[i][j][e] += pv[i][u] * vv;
            }
          }
        }
      }
    }
  }

  // epilogue: O = acc / l, lse = m + log(l)
#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    const int row = q0 + ty * C::RQ + i;
    if (row >= Tq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    const float inv = 1.f / l;
    T* op = o + ((static_cast<int64_t>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        store_value(op + (j * 16 + tx) * C::VEC + e, acc[i][j][e] * inv);
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Tq + row] = m_run[i] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Tq, int Tk, const int64_t* st,
                   float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + C::BQ - 1) / C::BQ, B * H);
  kern<<<grid, kThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int H, int Tq, int Tk, int D, const int64_t* st,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, stream);
    case 512:
      return launch<T, 512>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// q [B, Tq, H, D], k and v [B, Tk, H, D] with unit stride along D and the
// element strides (batch, token, head) of q, k, v in strides[0..8];
// o [B, Tq, H, D] contiguous; lse [B, H, Tq] float. dtype: 0 float, 1 bfloat16.
// Returns the CUDA error code of the launch (0 on success), -1 for a head
// width or type that has no kernel.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int H, int Tq,
                                   int Tk, int D, const int64_t* strides,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse, B, H, Tq, Tk, D, strides, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Tq, Tk, D, strides,
                                     scale, s);
  return -1;
}
