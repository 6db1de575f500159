// Flash attention at head widths above 512 in float32 on Hopper (sm_90a), FMA,
// plain C interface: the forward, dQ, and dK with dV.
//
// Replaces the TPU kernels tair_tpu/ops/flash_attention.py::_flash_kernel,
// ::_flash_dq_kernel and ::_flash_dkv_kernel at the head widths above 512 for
// float32 inputs, which are held to 1e-4 and so never go through TF32 or bf16
// tensor cores (flash_attention_colsplit_tc.cu serves bfloat16). The wrapper
// pads D with zeros to a multiple of 128. The same functions as
// flash_attention.cu and flash_attention_bwd.cu, which stop at D = 512.
//
// Bound on this card: operations (4, 6 and 8 * Tq * Tk * D flops at 67 TFLOP/s
// of float32 FMA). A simple kernel that is right: it serves the float32
// reference paths (phases reference and train_reference run D <= 512; this
// width only in checks), not the bfloat16 paths a user runs.
//
// Design: the column split of flash_attention_colsplit_tc.cu on the layout of
// flash_attention_bwd.cu's D = 512 kernels. A block of 256 threads per (16
// resident rows, batch*head, output slice of at most 512 columns; the slices
// share the D / 128 units of 128 columns out as evenly as they go, the rule
// of slice_of there). Per 16-row streamed tile, thread (i, j) = (tid / 16,
// tid % 16) forms entry (i, j) of S (and of dP) over the whole of D, 128
// columns at a time through shared memory, in one order, so every slice
// computes the same logits; then thread tid owns 8 rows and 4 columns of the
// slice (rows (tid / 128) * 8, columns (tid % 128) * 4; threads past the
// slice's width idle there) and adds the tile's product into them, the
// streamed rows in order. Each output is stored once; no atomics;
// deterministic. Keys past Tk get P = 0, rows past Tq are loaded as zeros and
// not stored. The [B, T, H, D] strides are taken as given.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using flash::kThreads;
using flash::load_tile;

constexpr int kR = 16;           // resident rows per block, streamed rows per tile
constexpr int kChunk = 128;      // columns of D per streamed chunk, and the width granule
constexpr int kSliceMax = 512;   // output columns of a block, at most
constexpr int kLDC = kChunk + 4;
constexpr int kLDV = kSliceMax + 4;
constexpr int kLDP = kR + 1;
constexpr int kRows = 8;         // output rows per thread
constexpr int kChunkFloats = kR * kLDC;
constexpr int kSliceFloats = kR * kLDV;
constexpr int kPFloats = kR * kLDP;
constexpr float kNegInf = -1e30f;
// forward: chunks of q and K, the V slice, P, and alpha and l of each row
constexpr int kFwdSmem = (2 * kChunkFloats + kSliceFloats + kPFloats + 2 * kR) *
                         static_cast<int>(sizeof(float));
// dQ: chunks of q, dO, K, V, the K slice, dS
constexpr int kDqSmem = (4 * kChunkFloats + kSliceFloats + kPFloats) *
                        static_cast<int>(sizeof(float));
// dK/dV: chunks of K, V, q, dO, the q and dO slices, P, dS
constexpr int kDkvSmem = (4 * kChunkFloats + 2 * kSliceFloats + 2 * kPFloats) *
                         static_cast<int>(sizeof(float));

struct Strides {
  int64_t q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, do_b, do_t, do_h;
};

struct Slice {
  int start, width;
};
__device__ inline Slice slice_of(int D, int s, int n) {
  const int units = D / kChunk;
  const int base = units / n;
  const int rem = units - base * n;
  return Slice{kChunk * (s * base + min(s, rem)), kChunk * (base + (s < rem ? 1 : 0))};
}

// A[i] . B[j] over one chunk, float4 at a time
__device__ inline float chunk_dot(const float* A, const float* B, int i, int j) {
  float s = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < kChunk; dd += 4) {
    const float4 a = *reinterpret_cast<const float4*>(&A[i * kLDC + dd]);
    const float4 b = *reinterpret_cast<const float4*>(&B[j * kLDC + dd]);
    s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  return s;
}

// acc[i][e] += sum over the tile's rows r of W[r][r0 + i] * X[r][col + e]
// (W a [streamed][resident] tile of P or dS, X a slice tile), rows in order
__device__ inline void add_product(float (&acc)[kRows][4], const float* W, bool transposed,
                                   const float* X, int r0, int col) {
#pragma unroll 4
  for (int r = 0; r < kR; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(&X[r * kLDV + col]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float w = transposed ? W[r * kLDP + r0 + i] : W[(r0 + i) * kLDP + r];
      acc[i][0] += w * x.x;
      acc[i][1] += w * x.y;
      acc[i][2] += w * x.z;
      acc[i][3] += w * x.w;
    }
  }
}

__device__ inline void store_rows(const float (&acc)[kRows][4], float* out, int64_t row_stride,
                                  int row0, int rows, int col) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (row0 + i >= rows) continue;
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(row0 + i) * row_stride + col) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------------------
// Forward: a block per (16 queries, batch*head, slice); K and V stream.
__global__ void __launch_bounds__(kThreads)
flash_fwd_colsplit_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Tq, int Tk, int D, Strides st,
                          float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qc = smem;
  float* Kc = Qc + kChunkFloats;
  float* Vs = Kc + kChunkFloats;
  float* Ps = Vs + kSliceFloats;   // [query][key]
  float* alpha_s = Ps + kPFloats;  // of each query row, this tile
  float* l_s = alpha_s + kR;       // of each query row, at the end

  const int tid = threadIdx.x;
  const int si = tid >> 4;
  const int sj = tid & 15;
  const int r0 = (tid >> 7) * kRows;
  const int col = (tid & 127) * 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kR;
  const Slice sl = slice_of(D, blockIdx.z, gridDim.z);
  const bool owns = col < sl.width;
  const int q_valid = min(kR, Tq - q0);
  const float* qp = q + b * st.q_b + h * st.q_h + static_cast<int64_t>(q0) * st.q_t;
  const float* kp = k + b * st.k_b + h * st.k_h;
  const float* vp = v + b * st.v_b + h * st.v_h + sl.start;

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // of row si; the 16 threads of the row agree

  for (int k0 = 0; k0 < Tk; k0 += kR) {
    const int k_valid = min(kR, Tk - k0);
    float s = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      __syncthreads();  // every thread is done with the last chunk (and the last tile)
      load_tile<float>(Qc, kLDC, qp + c0, st.q_t, kR, q_valid, kChunk, 1.f);
      load_tile<float>(Kc, kLDC, kp + static_cast<int64_t>(k0) * st.k_t + c0, st.k_t, kR,
                       k_valid, kChunk, 1.f);
      __syncthreads();
      s += chunk_dot(Qc, Kc, si, sj);
    }
    s = sj < k_valid ? s * scale : kNegInf;
    float mx = s;
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    const float p = expf(s - m_new);
    float sum = p;
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    Ps[si * kLDP + sj] = p;
    if (sj == 0) alpha_s[si] = alpha;
    load_tile<float>(Vs, kLDV, vp + static_cast<int64_t>(k0) * st.v_t, st.v_t, kR, k_valid,
                     sl.width, 1.f);
    __syncthreads();  // P, alpha and the V slice
    if (owns) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float a = alpha_s[r0 + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= a;
      }
      add_product(acc, Ps, false, Vs, r0, col);  // O += P V over the slice
    }
  }
  if (sj == 0) l_s[si] = l_run;
  __syncthreads();
  if (owns) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float inv = 1.f / fmaxf(l_s[r0 + i], 1e-30f);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= inv;
    }
    store_rows(acc, o + (static_cast<int64_t>(b) * Tq * H + h) * D + sl.start,
               static_cast<int64_t>(H) * D, q0 + r0, Tq, col);
  }
  if (blockIdx.z == 0 && sj == 0 && q0 + si < Tq)
    lse[(static_cast<int64_t>(b) * H + h) * Tq + q0 + si] = m_run + logf(fmaxf(l_run, 1e-30f));
}

// ---------------------------------------------------------------------------
// dQ: a block per (16 queries, batch*head, slice); K and V stream.
__global__ void __launch_bounds__(kThreads)
flash_dq_colsplit_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int Tq, int Tk, int D, Strides st,
                         float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qc = smem;
  float* dOc = Qc + kChunkFloats;
  float* Kc = dOc + kChunkFloats;
  float* Vc = Kc + kChunkFloats;
  float* Ks = Vc + kChunkFloats;   // the tile's K slice
  float* dSs = Ks + kSliceFloats;  // [query][key]

  const int tid = threadIdx.x;
  const int si = tid >> 4;
  const int sj = tid & 15;
  const int r0 = (tid >> 7) * kRows;
  const int col = (tid & 127) * 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kR;
  const Slice sl = slice_of(D, blockIdx.z, gridDim.z);
  const bool owns = col < sl.width;
  const int q_valid = min(kR, Tq - q0);
  const float* qp = q + b * st.q_b + h * st.q_h + static_cast<int64_t>(q0) * st.q_t;
  const float* dop = dO + b * st.do_b + h * st.do_h + static_cast<int64_t>(q0) * st.do_t;
  const float* kp = k + b * st.k_b + h * st.k_h;
  const float* vp = v + b * st.v_b + h * st.v_h;
  const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + q0 + si;
  const float row_lse = si < q_valid ? lse[at] : 0.f;
  const float row_delta = si < q_valid ? delta[at] : 0.f;

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kR) {
    const int k_valid = min(kR, Tk - k0);
    float s = 0.f, dp = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      __syncthreads();
      load_tile<float>(Qc, kLDC, qp + c0, st.q_t, kR, q_valid, kChunk, 1.f);
      load_tile<float>(dOc, kLDC, dop + c0, st.do_t, kR, q_valid, kChunk, 1.f);
      load_tile<float>(Kc, kLDC, kp + static_cast<int64_t>(k0) * st.k_t + c0, st.k_t, kR,
                       k_valid, kChunk, 1.f);
      load_tile<float>(Vc, kLDC, vp + static_cast<int64_t>(k0) * st.v_t + c0, st.v_t, kR,
                       k_valid, kChunk, 1.f);
      __syncthreads();
      s += chunk_dot(Qc, Kc, si, sj);
      dp += chunk_dot(dOc, Vc, si, sj);
    }
    const float p = sj < k_valid ? expf(s * scale - row_lse) : 0.f;
    dSs[si * kLDP + sj] = p * (dp - row_delta) * scale;
    load_tile<float>(Ks, kLDV, kp + static_cast<int64_t>(k0) * st.k_t + sl.start, st.k_t, kR,
                     k_valid, sl.width, 1.f);
    __syncthreads();  // dS and the K slice
    if (owns) add_product(acc, dSs, false, Ks, r0, col);  // dQ += dS K over the slice
  }
  if (owns)
    store_rows(acc, dq + (static_cast<int64_t>(b) * Tq * H + h) * D + sl.start,
               static_cast<int64_t>(H) * D, q0 + r0, Tq, col);
}

// ---------------------------------------------------------------------------
// dK, dV: a block per (16 keys, batch*head, slice); q, dO, lse and delta stream.
__global__ void __launch_bounds__(kThreads)
flash_dkv_colsplit_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk,
                          int D, Strides st, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Kc = smem;
  float* Vc = Kc + kChunkFloats;
  float* Qc = Vc + kChunkFloats;
  float* dOc = Qc + kChunkFloats;
  float* Qs = dOc + kChunkFloats;  // the tile's q slice
  float* dOs = Qs + kSliceFloats;  // the tile's dO slice
  float* Ps = dOs + kSliceFloats;  // [query][key]
  float* dSs = Ps + kPFloats;      // [query][key]

  const int tid = threadIdx.x;
  const int si = tid >> 4;  // query of the thread's S entry
  const int sj = tid & 15;  // key of the thread's S entry
  const int r0 = (tid >> 7) * kRows;
  const int col = (tid & 127) * 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kR;
  const Slice sl = slice_of(D, blockIdx.z, gridDim.z);
  const bool owns = col < sl.width;
  const int k_valid = min(kR, Tk - k0);
  const float* kp = k + b * st.k_b + h * st.k_h + static_cast<int64_t>(k0) * st.k_t;
  const float* vp = v + b * st.v_b + h * st.v_h + static_cast<int64_t>(k0) * st.v_t;
  const float* qp = q + b * st.q_b + h * st.q_h;
  const float* dop = dO + b * st.do_b + h * st.do_h;
  const float* lsep = lse + (static_cast<int64_t>(b) * H + h) * Tq;
  const float* deltap = delta + (static_cast<int64_t>(b) * H + h) * Tq;

  float acc_k[kRows][4], acc_v[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[i][e] = 0.f;
      acc_v[i][e] = 0.f;
    }

  for (int q0 = 0; q0 < Tq; q0 += kR) {
    const int q_valid = min(kR, Tq - q0);
    float s = 0.f, dp = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      __syncthreads();
      load_tile<float>(Kc, kLDC, kp + c0, st.k_t, kR, k_valid, kChunk, 1.f);
      load_tile<float>(Vc, kLDC, vp + c0, st.v_t, kR, k_valid, kChunk, 1.f);
      load_tile<float>(Qc, kLDC, qp + static_cast<int64_t>(q0) * st.q_t + c0, st.q_t, kR,
                       q_valid, kChunk, 1.f);
      load_tile<float>(dOc, kLDC, dop + static_cast<int64_t>(q0) * st.do_t + c0, st.do_t, kR,
                       q_valid, kChunk, 1.f);
      __syncthreads();
      s += chunk_dot(Qc, Kc, si, sj);
      dp += chunk_dot(dOc, Vc, si, sj);
    }
    const bool ok = si < q_valid && sj < k_valid;
    const float p = ok ? expf(s * scale - lsep[q0 + si]) : 0.f;
    Ps[si * kLDP + sj] = p;
    dSs[si * kLDP + sj] = ok ? p * (dp - deltap[q0 + si]) * scale : 0.f;
    load_tile<float>(Qs, kLDV, qp + static_cast<int64_t>(q0) * st.q_t + sl.start, st.q_t, kR,
                     q_valid, sl.width, 1.f);
    load_tile<float>(dOs, kLDV, dop + static_cast<int64_t>(q0) * st.do_t + sl.start, st.do_t,
                     kR, q_valid, sl.width, 1.f);
    __syncthreads();  // P, dS and the q and dO slices
    if (owns) {
      add_product(acc_v, Ps, true, dOs, r0, col);  // dV += P^T dO over the slice
      add_product(acc_k, dSs, true, Qs, r0, col);  // dK += dS^T q over the slice
    }
  }
  if (owns) {
    const int64_t head = (static_cast<int64_t>(b) * Tk * H + h) * D + sl.start;
    store_rows(acc_k, dk + head, static_cast<int64_t>(H) * D, k0 + r0, Tk, col);
    store_rows(acc_v, dv + head, static_cast<int64_t>(H) * D, k0 + r0, Tk, col);
  }
}

Strides make_strides(const int64_t* s, bool backward) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                 backward ? s[9] : 0, backward ? s[10] : 0, backward ? s[11] : 0};
}

// a head width these kernels take: above 512, a multiple of 128
bool takes(int D) { return D > kSliceMax && D % kChunk == 0; }

dim3 grid_of(int rows, int B, int H, int D) {
  return dim3((rows + kR - 1) / kR, B * H, (D / kChunk + 3) / 4);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// q [B, Tq, H, D], k and v [B, Tk, H, D], float, D above 512 and a multiple
// of 128, with unit stride along D, rows 16-byte aligned and the element
// strides (batch, token, head) of q, k, v in strides[0..8]; o [B, Tq, H, D]
// float contiguous; lse [B, H, Tq] float. Returns the CUDA error code of the
// launch (0 on success), -1 for a head width these kernels do not take.
extern "C" int flash_attention_fwd_colsplit(const void* q, const void* k, const void* v,
                                            void* o, float* lse, int B, int H, int Tq, int Tk,
                                            int D, const int64_t* strides, float scale,
                                            void* stream) {
  if (!takes(D)) return -1;
  cudaError_t err = allow_smem(flash_fwd_colsplit_kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_colsplit_kernel<<<grid_of(Tq, B, H, D), kThreads, kFwdSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, Tq, Tk, D, make_strides(strides, false), scale);
  return cudaGetLastError();
}

// As flash_attention_fwd_colsplit, with dO [B, Tq, H, D] (its strides in
// strides[9..11]), lse and delta [B, H, Tq] float contiguous; dq [B, Tq, H, D]
// float contiguous.
extern "C" int flash_attention_dq_colsplit(const void* q, const void* k, const void* v,
                                           const void* dO, const float* lse, const float* delta,
                                           void* dq, int B, int H, int Tq, int Tk, int D,
                                           const int64_t* strides, float scale, void* stream) {
  if (!takes(D)) return -1;
  cudaError_t err = allow_smem(flash_dq_colsplit_kernel, kDqSmem);
  if (err != cudaSuccess) return err;
  flash_dq_colsplit_kernel<<<grid_of(Tq, B, H, D), kThreads, kDqSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dO), lse, delta, static_cast<float*>(dq), H, Tq, Tk, D,
      make_strides(strides, true), scale);
  return cudaGetLastError();
}

// As flash_attention_dq_colsplit; dk, dv [B, Tk, H, D] float contiguous.
extern "C" int flash_attention_dkv_colsplit(const void* q, const void* k, const void* v,
                                            const void* dO, const float* lse,
                                            const float* delta, void* dk, void* dv, int B,
                                            int H, int Tq, int Tk, int D,
                                            const int64_t* strides, float scale, void* stream) {
  if (!takes(D)) return -1;
  cudaError_t err = allow_smem(flash_dkv_colsplit_kernel, kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_dkv_colsplit_kernel<<<grid_of(Tk, B, H, D), kThreads, kDkvSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dO), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      H, Tq, Tk, D, make_strides(strides, true), scale);
  return cudaGetLastError();
}
