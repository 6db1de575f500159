// Flash attention backward for Hopper (sm_90a), plain C interface: dQ, and
// dK with dV.
//
// Replaces the TPU kernels tair_tpu/ops/flash_attention.py::_flash_dq_kernel
// and ::_flash_dkv_kernel (both driven by _flash_attention_bwd). With
//   P  = exp(scale * q k^T - lse)        (recomputed, never stored)
//   dP = dO v^T
//   dS = P * (dP - delta) * scale,   delta = rowsum(dO * O)
// they give dQ = dS k, dK = dS^T q and dV = P^T dO. lse comes from the forward
// kernel and delta from the wrapper, both float [B, H, Tq].
//
// Bound on this card: operations, like the forward. dQ does three products of
// 2*Tq*Tk*D flops per (batch, head), dK/dV four, over inputs of a few Tq*D
// values, so neither P nor dS may reach device memory.
//
// Design: the forward's thread layout. One block of 256 threads holds a tile
// of 64 rows (queries for dQ, keys for dK/dV) for its whole life and streams
// 64-row tiles of the other side through shared memory. A thread forms a 4 x 4
// piece of the logits and of dP in one pass over D, turns them into P and dS,
// and leaves those in shared memory; the second pass multiplies them with the
// streamed tile into float register accumulators that are stored once at the
// end. dK/dV therefore needs no atomics and is deterministic: a key tile is
// owned by one block, and the queries are summed in order. Keys past Tk get
// P = 0; rows past Tq are loaded as zeros (q, dO, lse and delta alike), so they
// add nothing to either product, and no padded row is ever stored. The
// [B, T, H, D] strides of q, k, v and dO are taken as given. Head widths up to
// 128; D = 512 is the autoencoder's, which is never differentiated. Products
// are plain FMA: no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "vec_load.cuh"

namespace {

using flash::kBK;
using flash::kThreads;
using flash::load_tile;

template <int D>
struct Cfg {
  static constexpr int BT = 64;                       // rows of the resident tile
  static constexpr int R = 4;                         // rows per thread
  static constexpr int VEC = (D >= 64) ? 4 : D / 16;  // output columns per vector
  static constexpr int NCV = D / (16 * VEC);          // vectors per thread
  static constexpr int LD = D + 4;                    // row pitch of a [64, D] tile
  static constexpr int LDP = kBK + 4;                 // row pitch of a [64, 64] tile
  static constexpr int TILE = BT * LD;
  static constexpr int PTILE = BT * LDP;
  static constexpr int DQ_SMEM = (4 * TILE + PTILE) * static_cast<int>(sizeof(float));
  static constexpr int DKV_SMEM = (4 * TILE + 2 * PTILE) * static_cast<int>(sizeof(float));
};

struct Strides {
  int64_t q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, do_b, do_t, do_h;
};

// s[i][j] = sum_d A[(ra + i)][d] * B[(tx + 16 j)][d] and the same for the
// second pair of tiles, in one pass over D.
template <int D>
__device__ inline void two_products(const float* A1, const float* B1,
                                    const float* A2, const float* B2, int ra,
                                    int tx, float (&s)[4][4], float (&t)[4][4]) {
  using C = Cfg<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      t[i][j] = 0.f;
    }
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    float4 a1[4], b1[4], a2[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a1[i] = *reinterpret_cast<const float4*>(&A1[(ra + i) * C::LD + dd]);
      a2[i] = *reinterpret_cast<const float4*>(&A2[(ra + i) * C::LD + dd]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b1[j] = *reinterpret_cast<const float4*>(&B1[(tx + 16 * j) * C::LD + dd]);
      b2[j] = *reinterpret_cast<const float4*>(&B2[(tx + 16 * j) * C::LD + dd]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a1[i].x * b1[j].x + a1[i].y * b1[j].y + a1[i].z * b1[j].z +
                   a1[i].w * b1[j].w;
        t[i][j] += a2[i].x * b2[j].x + a2[i].y * b2[j].y + a2[i].z * b2[j].z +
                   a2[i].w * b2[j].w;
      }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (batch*head, tile of 64 queries); K and V stream.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int Tq, int Tk, Strides st,
                float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // scale * q
  float* dOs = Qs + C::TILE;
  float* Ks = dOs + C::TILE;
  float* Vs = Ks + C::TILE;
  float* dSs = Vs + C::TILE;   // [query][key]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * C::BT;
  const int q_valid = min(C::BT, Tq - q0);

  const T* qp = q + b * st.q_b + h * st.q_h + static_cast<int64_t>(q0) * st.q_t;
  const T* dop = dO + b * st.do_b + h * st.do_h + static_cast<int64_t>(q0) * st.do_t;
  const T* kp = k + b * st.k_b + h * st.k_h;
  const T* vp = v + b * st.v_b + h * st.v_h;

  load_tile<T>(Qs, C::LD, qp, st.q_t, C::BT, q_valid, D, scale);
  load_tile<T>(dOs, C::LD, dop, st.do_t, C::BT, q_valid, D, 1.f);

  float row_lse[C::R], row_delta[C::R];
#pragma unroll
  for (int i = 0; i < C::R; ++i) {
    const int row = q0 + ty * C::R + i;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + row;
    row_lse[i] = row < Tq ? lse[at] : 0.f;
    row_delta[i] = row < Tq ? delta[at] : 0.f;
  }

  float acc[C::R][C::NCV][C::VEC];
#pragma unroll
  for (int i = 0; i < C::R; ++i)
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    const int k_valid = min(kBK, Tk - k0);
    __syncthreads();  // the last tile's readers are done (and Q, dO are loaded)
    load_tile<T>(Ks, C::LD, kp + static_cast<int64_t>(k0) * st.k_t, st.k_t, kBK,
                 k_valid, D, 1.f);
    load_tile<T>(Vs, C::LD, vp + static_cast<int64_t>(k0) * st.v_t, st.v_t, kBK,
                 k_valid, D, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, ty * C::R, tx, s, dp);
#pragma unroll
    for (int i = 0; i < C::R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            (tx + 16 * j < k_valid) ? expf(s[i][j] - row_lse[i]) : 0.f;
        dSs[(ty * C::R + i) * C::LDP + tx + 16 * j] =
            p * (dp[i][j] - row_delta[i]) * scale;
      }
    __syncthreads();

    // acc += dS k
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float ds[C::R][4];
#pragma unroll
      for (int i = 0; i < C::R; ++i) {
        const float4 t4 = *reinterpret_cast<const float4*>(
            &dSs[(ty * C::R + i) * C::LDP + kk]);
        ds[i][0] = t4.x;
        ds[i][1] = t4.y;
        ds[i][2] = t4.z;
        ds[i][3] = t4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < C::NCV; ++j) {
          const float* krow = &Ks[(kk + u) * C::LD + (j * 16 + tx) * C::VEC];
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) {
            const float kv = krow[e];
#pragma unroll
            for (int i = 0; i < C::R; ++i) acc[i][j][e] += ds[i][u] * kv;
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < C::R; ++i) {
    const int row = q0 + ty * C::R + i;
    if (row >= Tq) continue;
    T* op = dq + ((static_cast<int64_t>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        store_value(op + (j * 16 + tx) * C::VEC + e, acc[i][j][e]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (batch*head, tile of 64 keys); q, dO, lse, delta stream.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                 Strides st, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;            // scale * k
  float* Vs = Ks + C::TILE;
  float* Qs = Vs + C::TILE;
  float* dOs = Qs + C::TILE;
  float* Ps = dOs + C::TILE;   // [query][key]
  float* dSs = Ps + C::PTILE;  // [query][key]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * C::BT;
  const int k_valid = min(C::BT, Tk - k0);

  const T* kp = k + b * st.k_b + h * st.k_h + static_cast<int64_t>(k0) * st.k_t;
  const T* vp = v + b * st.v_b + h * st.v_h + static_cast<int64_t>(k0) * st.v_t;
  const T* qp = q + b * st.q_b + h * st.q_h;
  const T* dop = dO + b * st.do_b + h * st.do_h;
  const float* lsep = lse + (static_cast<int64_t>(b) * H + h) * Tq;
  const float* deltap = delta + (static_cast<int64_t>(b) * H + h) * Tq;

  load_tile<T>(Ks, C::LD, kp, st.k_t, C::BT, k_valid, D, scale);
  load_tile<T>(Vs, C::LD, vp, st.v_t, C::BT, k_valid, D, 1.f);

  // this thread's piece of dK and dV: key rows ty*4 .. ty*4+3
  float acc_k[C::R][C::NCV][C::VEC], acc_v[C::R][C::NCV][C::VEC];
#pragma unroll
  for (int i = 0; i < C::R; ++i)
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) {
        acc_k[i][j][e] = 0.f;
        acc_v[i][j][e] = 0.f;
      }

  for (int q0 = 0; q0 < Tq; q0 += C::BT) {
    const int q_valid = min(C::BT, Tq - q0);
    __syncthreads();  // the last tile's readers are done (and K, V are loaded)
    load_tile<T>(Qs, C::LD, qp + static_cast<int64_t>(q0) * st.q_t, st.q_t,
                 C::BT, q_valid, D, 1.f);
    load_tile<T>(dOs, C::LD, dop + static_cast<int64_t>(q0) * st.do_t, st.do_t,
                 C::BT, q_valid, D, 1.f);
    __syncthreads();

    // logits and dP for query rows ty*4+i, key columns tx+16j
    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, ty * C::R, tx, s, dp);
#pragma unroll
    for (int i = 0; i < C::R; ++i) {
      const int row = ty * C::R + i;
      const bool row_ok = row < q_valid;
      const float l = row_ok ? lsep[q0 + row] : 0.f;
      const float dl = row_ok ? deltap[q0 + row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (row_ok && tx + 16 * j < k_valid)
                            ? expf(s[i][j] - l) : 0.f;
        Ps[row * C::LDP + tx + 16 * j] = p;
        dSs[row * C::LDP + tx + 16 * j] = p * (dp[i][j] - dl) * scale;
      }
    }
    __syncthreads();

    // acc_v += P^T dO, acc_k += dS^T q, summed over the tile's queries in order
#pragma unroll 2
    for (int qq = 0; qq < C::BT; ++qq) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(&Ps[qq * C::LDP + ty * C::R]);
      const float4 s4 =
          *reinterpret_cast<const float4*>(&dSs[qq * C::LDP + ty * C::R]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int j = 0; j < C::NCV; ++j) {
        const float* dorow = &dOs[qq * C::LD + (j * 16 + tx) * C::VEC];
        const float* qrow = &Qs[qq * C::LD + (j * 16 + tx) * C::VEC];
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) {
          const float dov = dorow[e];
          const float qv = qrow[e];
#pragma unroll
          for (int i = 0; i < C::R; ++i) {
            acc_v[i][j][e] += pr[i] * dov;
            acc_k[i][j][e] += sr[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::R; ++i) {
    const int row = k0 + ty * C::R + i;
    if (row >= Tk) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Tk + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < C::NCV; ++j)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) {
        store_value(dk + at + (j * 16 + tx) * C::VEC + e, acc_k[i][j][e]);
        store_value(dv + at + (j * 16 + tx) * C::VEC + e, acc_v[i][j][e]);
      }
  }
}

Strides make_strides(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Tq, int Tk, const int64_t* st, float scale,
              cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + C::BT - 1) / C::BT, B * H);
  kern<<<grid, kThreads, C::DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dq), H, Tq, Tk, make_strides(st), scale);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* delta, void* dk, void* dv, int B,
               int H, int Tq, int Tk, const int64_t* st, float scale,
               cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKV_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + C::BT - 1) / C::BT, B * H);
  kern<<<grid, kThreads, C::DKV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, make_strides(st),
      scale);
  return cudaGetLastError();
}

#define FLASH_BWD_DISPATCH(FN, ...)                 \
  switch (D) {                                      \
    case 16:  return FN<T, 16>(__VA_ARGS__);        \
    case 32:  return FN<T, 32>(__VA_ARGS__);        \
    case 64:  return FN<T, 64>(__VA_ARGS__);        \
    case 128: return FN<T, 128>(__VA_ARGS__);       \
    default:  return -1;                            \
  }

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dO,
                const float* lse, const float* delta, void* dq, int B, int H,
                int Tq, int Tk, int D, const int64_t* st, float scale,
                cudaStream_t stream) {
  FLASH_BWD_DISPATCH(launch_dq, q, k, v, dO, lse, delta, dq, B, H, Tq, Tk, st,
                     scale, stream)
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* delta, void* dk, void* dv,
                 int B, int H, int Tq, int Tk, int D, const int64_t* st,
                 float scale, cudaStream_t stream) {
  FLASH_BWD_DISPATCH(launch_dkv, q, k, v, dO, lse, delta, dk, dv, B, H, Tq, Tk,
                     st, scale, stream)
}

}  // namespace

// q, dO [B, Tq, H, D] and k, v [B, Tk, H, D] with unit stride along D and the
// element strides (batch, token, head) of q, k, v, dO in strides[0..11];
// lse, delta [B, H, Tq] float contiguous; dq [B, Tq, H, D] contiguous in the
// inputs' type. dtype: 0 float, 1 bfloat16. Returns the CUDA error code of the
// launch (0 on success), -1 for a head width or type that has no kernel.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dO, const float* lse,
                                  const float* delta, void* dq, int B, int H,
                                  int Tq, int Tk, int D, const int64_t* strides,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, dO, lse, delta, dq, B, H, Tq, Tk, D,
                              strides, scale, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dO, lse, delta, dq, B, H, Tq, Tk,
                                      D, strides, scale, s);
  return -1;
}

// As flash_attention_dq; dk, dv [B, Tk, H, D] contiguous in the inputs' type.
extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dO, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int B, int H, int Tq, int Tk, int D,
                                   const int64_t* strides, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, dO, lse, delta, dk, dv, B, H, Tq, Tk, D,
                               strides, scale, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dO, lse, delta, dk, dv, B, H,
                                       Tq, Tk, D, strides, scale, s);
  return -1;
}
