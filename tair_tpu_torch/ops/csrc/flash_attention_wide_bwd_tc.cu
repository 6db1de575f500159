// Flash attention backward at head width 512 on the tensor cores of Hopper
// (sm_90a), bfloat16, plain C interface: dQ, and dK with dV.
//
// Replaces the TPU kernels tair_tpu/ops/flash_attention.py::_flash_dq_kernel
// and ::_flash_dkv_kernel (driven by _flash_attention_bwd) at the
// autoencoder's head width: the single-head middle attention of the VAE's
// encoder and decoder, T = 4096 at 512 x 512. With P = exp(scale * q k^T -
// lse) rebuilt from the logsumexp of the wide forward
// (flash_attention_wide_tc.cu), dP = dO v^T and dS = P * (dP - delta) * scale
// (delta = rowsum(dO * O), float [B, H, Tq] from the wrapper), it gives dQ =
// dS k, dK = dS^T q and dV = P^T dO. flash_attention_dq_tc.cu and
// flash_attention_dkv_tc.cu serve D <= 128; flash_attention_bwd.cu keeps
// float32.
//
// Bound on this card: operations. dQ does three products of 2*Tq*Tk*512
// flops per (batch, head), dK/dV four, over a few (Tq + Tk)*512 values.
//
// Design: the wide forward's. The narrow kernels' layout, where a warp owns
// 16 rows across all of D, does not widen to 512: a warp's accumulators would
// be 256 floats a thread (dQ) or 512 (dK and dV). Here the logits are shared
// across the warps and each warp owns a slice of the output columns;
// mma.sync m16n8k16, bf16 operands, float accumulators. A block of 8 warps
// keeps 32 rows of the resident side and streams 32-row tiles of the other:
//   S, dP   each warp forms the partial products of 16 rows x 32 columns over
//           a quarter of D (2 row groups x 4 quarters); the partials meet in
//           shared memory, and each warp adds the four quarters, in order, of
//           its 16 rows x 8 columns, rebuilds P from lse and forms dS;
//   P, dS   go to shared memory as two bf16 terms each (hi + lo): one bf16
//           term fails the elementwise tolerance of gradients near 0, as in
//           the narrow kernels (the CPU emulation in
//           tests/test_torch_flash_attention.py);
//   output  each warp owns 64 output columns for all 32 rows (2 m-tiles x 8
//           n-tiles), the streamed tile by ldmatrix.trans.
// dQ: one block per (batch*head, 32 queries); q and dO are held in registers
// as A fragments (a quarter of D each, loaded once), tiles of 32 keys of K and
// V go through a two-stage cp.async ring; 64 accumulator floats a thread.
// dK/dV: one block per (batch*head, 32 keys); K and V stay in shared memory and
// are read as A fragments per tile (in registers they would join 128
// accumulator floats a thread); tiles of 32 queries of q and dO, one stage
// (two stages would pass the 227 KB a block may have). Shared memory: 200 KB
// (dQ), 176 KB (dK/dV); one block per SM, 128 blocks at T = 4096, H = 1. No
// atomics: every output is stored once, deterministic. Keys past Tk get P = 0
// (never NaN); rows past Tq are loaded as zeros, masked to P = 0 in dK/dV,
// and not stored. The [B, T, H, D] strides are taken as given: rows must be
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
constexpr int kD = 512;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kB = 32;               // resident rows per block, streamed rows per tile
constexpr int kCols = kD / kWarps;   // output columns per warp
constexpr int kDQuarter = kD / 4;    // columns of a warp's partial products
constexpr int kLD = kD + 8;          // row pitch of a [32, 512] tile
constexpr int kLDP = kB + 8;         // row pitch of the P and dS tiles
constexpr int kLDS = kB + 4;         // row pitch of the partial products, in floats
constexpr int kTileElems = kB * kLD;
constexpr int kPElems = kB * kLDP;
constexpr int kPartialBytes = 2 * 4 * kB * kLDS * static_cast<int>(sizeof(float));
constexpr int kTileBytes = kTileElems * static_cast<int>(sizeof(bf16));
// dQ: q and dO (whose room the partials take once q and dO are in registers),
// two stages of K and V, dS as two terms
constexpr int kDqSmem = 2 * kTileBytes + 4 * kTileBytes +
                        2 * kPElems * static_cast<int>(sizeof(bf16));
// dK/dV: K, V, one stage of q and dO, the partials, P and dS as two terms
// each, lse and delta of a query tile
constexpr int kDkvSmem = 4 * kTileBytes + kPartialBytes +
                         4 * kPElems * static_cast<int>(sizeof(bf16)) +
                         2 * kB * static_cast<int>(sizeof(float));
static_assert(kPartialBytes <= 2 * kTileBytes, "the partials take q's and dO's room");
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, do_b, do_t, do_h;
};

// The warp's partial products over its quarter `dq` of D: s = A1 B1^T and
// t = A2 B2^T for the 16 rows of row group rg and all 32 columns, the A
// operands given as fragments by `a1`/`a2` (one 16-deep step at a time) and
// the B operands as [column][d] tiles in shared memory.
template <typename FragA1, typename FragA2>
__device__ inline void partial_products(FragA1 a1, FragA2 a2, const bf16* B1, const bf16* B2,
                                        int dq, int lane, float (&s)[kB / 8][4],
                                        float (&t)[kB / 8][4]) {
#pragma unroll
  for (int j = 0; j < kB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 0.f;
      t[j][e] = 0.f;
    }
#pragma unroll
  for (int kk = 0; kk < kDQuarter / 16; ++kk) {
    uint32_t fa1[4], fa2[4];
    a1(kk, fa1);
    a2(kk, fa2);
#pragma unroll
    for (int np = 0; np < kB / 16; ++np) {
      uint32_t b1[4], b2[4];
      tc::ldmatrix_x4(b1, tc::b_rows(B1, kLD, np * 16, dq * kDQuarter + kk * 16, lane));
      tc::ldmatrix_x4(b2, tc::b_rows(B2, kLD, np * 16, dq * kDQuarter + kk * 16, lane));
      tc::mma(s[2 * np], fa1, b1[0], b1[1]);
      tc::mma(s[2 * np + 1], fa1, b1[2], b1[3]);
      tc::mma(t[2 * np], fa2, b2[0], b2[1]);
      tc::mma(t[2 * np + 1], fa2, b2[2], b2[3]);
    }
  }
}

// The partials into shared memory ([quarter][row][column], two arrays).
__device__ inline void store_partials(float* red_s, float* red_t, const float (&s)[kB / 8][4],
                                      const float (&t)[kB / 8][4], int dq, int rg, int g,
                                      int c) {
#pragma unroll
  for (int j = 0; j < kB / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = (dq * kB + rg * 16 + g + 8 * i) * kLDS + j * 8 + c;
      *reinterpret_cast<float2*>(red_s + at) = make_float2(s[j][2 * i], s[j][2 * i + 1]);
      *reinterpret_cast<float2*>(red_t + at) = make_float2(t[j][2 * i], t[j][2 * i + 1]);
    }
}

// The whole products for rows rg*16 + g (+ 8) and columns kg*8 + c (+ 1): the
// four quarters added in order.
__device__ inline void sum_partials(const float* red_s, const float* red_t, int rg, int kg,
                                    int g, int c, float (&s)[4], float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[e] = 0.f;
    t[e] = 0.f;
  }
#pragma unroll
  for (int part = 0; part < 4; ++part)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = (part * kB + rg * 16 + g + 8 * i) * kLDS + kg * 8 + c;
      const float2 x = *reinterpret_cast<const float2*>(red_s + at);
      const float2 y = *reinterpret_cast<const float2*>(red_t + at);
      s[2 * i] += x.x;
      s[2 * i + 1] += x.y;
      t[2 * i] += y.x;
      t[2 * i + 1] += y.y;
    }
}

// acc += A B over one 32-deep tile for the warp's 64 columns: A (32 x 32) as
// hi + lo bf16 tiles, B a [32][512] tile read by ldmatrix.trans.
__device__ inline void product_into(float (&acc)[2][kCols / 8][4], const bf16* Ah,
                                    const bf16* Al, const bf16* Bt, int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < kB / 16; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      tc::ldmatrix_x4(ah[mt], tc::a_rows(Ah, kLDP, mt * 16, ks * 16, lane));
      tc::ldmatrix_x4(al[mt], tc::a_rows(Al, kLDP, mt * 16, ks * 16, lane));
    }
#pragma unroll
    for (int dp = 0; dp < kCols / 16; ++dp) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, tc::a_rows(Bt, kLD, ks * 16, warp * kCols + dp * 16, lane));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        tc::mma(acc[mt][2 * dp], ah[mt], b[0], b[1]);
        tc::mma(acc[mt][2 * dp + 1], ah[mt], b[2], b[3]);
        tc::mma(acc[mt][2 * dp], al[mt], b[0], b[1]);
        tc::mma(acc[mt][2 * dp + 1], al[mt], b[2], b[3]);
      }
    }
  }
}

__device__ inline void zero(float (&acc)[2][kCols / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

// Rows row0 + mt*16 + g (+ 8) of the warp's 64 columns, in bf16, rows at or
// past `rows` skipped; `out` points at row 0, column 0 of the (batch, head).
__device__ inline void store_rows(const float (&acc)[2][kCols / 8][4], bf16* out,
                                  int64_t row_stride, int row0, int rows, int warp, int g,
                                  int c) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int mt = r >> 1;
    const int i = r & 1;
    const int row = row0 + mt * 16 + g + 8 * i;
    if (row >= rows) continue;
    bf16* op = out + static_cast<int64_t>(row) * row_stride + warp * kCols + c;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(acc[mt][j][2 * i], acc[mt][j][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (batch*head, 32 queries); K and V stream.
__global__ void __launch_bounds__(kThreads)
flash_dq_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Tq, int Tk, Strides st,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTileElems;
  float* red_s = reinterpret_cast<float*>(smem_raw);  // once q and dO are in registers
  float* red_dp = red_s + 4 * kB * kLDS;
  bf16* Ks = dOs + kTileElems;    // two stages
  bf16* Vs = Ks + 2 * kTileElems;  // two stages
  bf16* dSh = Vs + 2 * kTileElems;
  bf16* dSl = dSh + kPElems;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
  const int rg = warp >> 2;  // row group of the warp's partial products
  const int qd = warp & 3;   // quarter of D of the warp's partial products
  const int kg = warp & 3;   // key group of the warp's dS tile
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kB;
  const bf16* qp = q + b * st.q_b + h * st.q_h + static_cast<int64_t>(q0) * st.q_t;
  const bf16* dop = dO + b * st.do_b + h * st.do_h + static_cast<int64_t>(q0) * st.do_t;
  const bf16* kp = k + b * st.k_b + h * st.k_h;
  const bf16* vp = v + b * st.v_b + h * st.v_h;
  const int n_tiles = (Tk + kB - 1) / kB;

  auto load_kv = [&](int t) {
    const int stage = t & 1;
    const int valid = min(kB, Tk - t * kB);
    const int64_t row = static_cast<int64_t>(t) * kB;
    tc::load_rows_async(Ks + stage * kTileElems, kLD, kp + row * st.k_t, st.k_t, kB, valid,
                        kD, kThreads);
    tc::load_rows_async(Vs + stage * kTileElems, kLD, vp + row * st.v_t, st.v_t, kB, valid,
                        kD, kThreads);
  };
  const int q_valid = min(kB, Tq - q0);
  tc::load_rows_async(Qs, kLD, qp, st.q_t, kB, q_valid, kD, kThreads);
  tc::load_rows_async(dOs, kLD, dop, st.do_t, kB, q_valid, kD, kThreads);
  load_kv(0);
  tc::cp_async_commit();

  // lse (log2 units) and delta of the thread's dS rows rg*16 + g (+ 8); rows
  // past Tq are zeros, whose dS is 0 and is never stored
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rg * 16 + g + 8 * i;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + row;
    lse2[i] = row < Tq ? lse[at] * kLog2e : 0.f;
    dl[i] = row < Tq ? delta[at] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[2][kCols / 8][4];
  zero(acc);
  uint32_t qf[kDQuarter / 16][4], dof[kDQuarter / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t is in shared memory, and every warp is done with tile t-1
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kDQuarter / 16; ++kk) {
        tc::ldmatrix_x4(qf[kk], tc::a_rows(Qs, kLD, rg * 16, qd * kDQuarter + kk * 16, lane));
        tc::ldmatrix_x4(dof[kk], tc::a_rows(dOs, kLD, rg * 16, qd * kDQuarter + kk * 16, lane));
      }
      __syncthreads();  // q and dO are in registers: the partials may take their room
    }
    if (t + 1 < n_tiles) {
      load_kv(t + 1);  // into the stage tile t-1 used
      tc::cp_async_commit();
    }
    const bf16* Kt = Ks + (t & 1) * kTileElems;
    const bf16* Vt = Vs + (t & 1) * kTileElems;

    float sp[kB / 8][4], dpp[kB / 8][4];
    partial_products([&](int kk, uint32_t(&f)[4]) {
#pragma unroll
                       for (int e = 0; e < 4; ++e) f[e] = qf[kk][e];
                     },
                     [&](int kk, uint32_t(&f)[4]) {
#pragma unroll
                       for (int e = 0; e < 4; ++e) f[e] = dof[kk][e];
                     },
                     Kt, Vt, qd, lane, sp, dpp);
    store_partials(red_s, red_dp, sp, dpp, qd, rg, g, c);
    __syncthreads();  // every quarter's partial S and dP

    float s[4], dp[4];
    sum_partials(red_s, red_dp, rg, kg, g, c, s, dp);
    const int key0 = t * kB + kg * 8 + c;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = key0 + e < Tk ? exp2f(s[2 * i + e] * scale_log2 - lse2[i]) : 0.f;
        ds[e] = p * (dp[2 * i + e] - dl[i]) * scale;
      }
      uint32_t hi, lo;
      tc::split(ds[0], ds[1], hi, lo);
      const int at = (rg * 16 + g + 8 * i) * kLDP + kg * 8 + c;
      *reinterpret_cast<uint32_t*>(dSh + at) = hi;
      *reinterpret_cast<uint32_t*>(dSl + at) = lo;
    }
    __syncthreads();  // dS

    product_into(acc, dSh, dSl, Kt, warp, lane);  // dQ += dS K
  }
  store_rows(acc, dq + (static_cast<int64_t>(b) * Tq * H + h) * kD, static_cast<int64_t>(H) * kD,
             q0, Tq, warp, g, c);
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (batch*head, 32 keys); q, dO, lse and delta stream.
__global__ void __launch_bounds__(kThreads)
flash_dkv_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq,
                         int Tk, Strides st, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileElems;
  bf16* Qs = Vs + kTileElems;
  bf16* dOs = Qs + kTileElems;
  float* red_s = reinterpret_cast<float*>(dOs + kTileElems);  // [quarter][key][query]
  float* red_dp = red_s + 4 * kB * kLDS;
  bf16* Ph = reinterpret_cast<bf16*>(red_dp + 4 * kB * kLDS);  // P^T [key][query]
  bf16* Pl = Ph + kPElems;
  bf16* dSh = Pl + kPElems;                                     // dS^T [key][query]
  bf16* dSl = dSh + kPElems;
  float* lse_s = reinterpret_cast<float*>(dSl + kPElems);       // log2 units
  float* delta_s = lse_s + kB;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
  const int rg = warp >> 2;  // key group of the warp's partial products
  const int qd = warp & 3;   // quarter of D of the warp's partial products
  const int qg = warp & 3;   // query group of the warp's P and dS tiles
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kB;
  const bf16* kp = k + b * st.k_b + h * st.k_h + static_cast<int64_t>(k0) * st.k_t;
  const bf16* vp = v + b * st.v_b + h * st.v_h + static_cast<int64_t>(k0) * st.v_t;
  const bf16* qp = q + b * st.q_b + h * st.q_h;
  const bf16* dop = dO + b * st.do_b + h * st.do_h;
  const float* lsep = lse + (static_cast<int64_t>(b) * H + h) * Tq;
  const float* deltap = delta + (static_cast<int64_t>(b) * H + h) * Tq;
  const int k_valid = min(kB, Tk - k0);
  tc::load_rows_async(Ks, kLD, kp, st.k_t, kB, k_valid, kD, kThreads);
  tc::load_rows_async(Vs, kLD, vp, st.v_t, kB, k_valid, kD, kThreads);
  const float scale_log2 = scale * kLog2e;

  float acc_k[2][kCols / 8][4], acc_v[2][kCols / 8][4];
  zero(acc_k);
  zero(acc_v);

  for (int q0 = 0; q0 < Tq; q0 += kB) {
    const int q_valid = min(kB, Tq - q0);
    __syncthreads();  // every warp is done with the last tile
    tc::load_rows_async(Qs, kLD, qp + static_cast<int64_t>(q0) * st.q_t, st.q_t, kB, q_valid,
                        kD, kThreads);
    tc::load_rows_async(dOs, kLD, dop + static_cast<int64_t>(q0) * st.do_t, st.do_t, kB,
                        q_valid, kD, kThreads);
    tc::cp_async_commit();
    if (threadIdx.x < kB) {
      const bool ok = static_cast<int>(threadIdx.x) < q_valid;
      lse_s[threadIdx.x] = ok ? lsep[q0 + threadIdx.x] * kLog2e : 0.f;
      delta_s[threadIdx.x] = ok ? deltap[q0 + threadIdx.x] : 0.f;
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // the tile (and, the first time, K and V) is in shared memory

    // S^T = K q^T and dP^T = V dO^T, K and V as A operands from shared memory
    float sp[kB / 8][4], dpp[kB / 8][4];
    partial_products(
        [&](int kk, uint32_t(&f)[4]) {
          tc::ldmatrix_x4(f, tc::a_rows(Ks, kLD, rg * 16, qd * kDQuarter + kk * 16, lane));
        },
        [&](int kk, uint32_t(&f)[4]) {
          tc::ldmatrix_x4(f, tc::a_rows(Vs, kLD, rg * 16, qd * kDQuarter + kk * 16, lane));
        },
        Qs, dOs, qd, lane, sp, dpp);
    store_partials(red_s, red_dp, sp, dpp, qd, rg, g, c);
    __syncthreads();  // every quarter's partial S^T and dP^T

    float s[4], dp[4];
    sum_partials(red_s, red_dp, rg, qg, g, c, s, dp);
    const int qi = qg * 8 + c;  // the thread's queries qi, qi + 1 of the tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = qi + e < q_valid ? exp2f(s[2 * i + e] * scale_log2 - lse_s[qi + e]) : 0.f;
        ds[e] = p[e] * (dp[2 * i + e] - delta_s[qi + e]) * scale;
      }
      const int at = (rg * 16 + g + 8 * i) * kLDP + qi;
      uint32_t hi, lo;
      tc::split(p[0], p[1], hi, lo);
      *reinterpret_cast<uint32_t*>(Ph + at) = hi;
      *reinterpret_cast<uint32_t*>(Pl + at) = lo;
      tc::split(ds[0], ds[1], hi, lo);
      *reinterpret_cast<uint32_t*>(dSh + at) = hi;
      *reinterpret_cast<uint32_t*>(dSl + at) = lo;
    }
    __syncthreads();  // P^T and dS^T

    product_into(acc_v, Ph, Pl, dOs, warp, lane);  // dV += P^T dO
    product_into(acc_k, dSh, dSl, Qs, warp, lane);  // dK += dS^T q
  }
  const int64_t head = (static_cast<int64_t>(b) * Tk * H + h) * kD;
  store_rows(acc_k, dk + head, static_cast<int64_t>(H) * kD, k0, Tk, warp, g, c);
  store_rows(acc_v, dv + head, static_cast<int64_t>(H) * kD, k0, Tk, warp, g, c);
}

Strides make_strides(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// q, dO [B, Tq, H, 512] and k, v [B, Tk, H, 512], bfloat16, with unit stride
// along D, rows 16-byte aligned and the element strides (batch, token, head) of
// q, k, v, dO in strides[0..11]; lse, delta [B, H, Tq] float contiguous; dq
// [B, Tq, H, 512] bfloat16 contiguous. Returns the CUDA error code of the
// launch (0 on success), -1 for a head width other than 512.
extern "C" int flash_attention_dq_wide_tc(const void* q, const void* k, const void* v,
                                          const void* dO, const float* lse,
                                          const float* delta, void* dq, int B, int H,
                                          int Tq, int Tk, int D, const int64_t* strides,
                                          float scale, void* stream) {
  if (D != kD) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kB - 1) / kB, B * H);
  flash_dq_wide_tc_kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dq), H, Tq, Tk,
      make_strides(strides), scale);
  return cudaGetLastError();
}

// As flash_attention_dq_wide_tc; dk, dv [B, Tk, H, 512] bfloat16 contiguous.
extern "C" int flash_attention_dkv_wide_tc(const void* q, const void* k, const void* v,
                                           const void* dO, const float* lse,
                                           const float* delta, void* dk, void* dv, int B,
                                           int H, int Tq, int Tk, int D,
                                           const int64_t* strides, float scale,
                                           void* stream) {
  if (D != kD) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kB - 1) / kB, B * H);
  flash_dkv_wide_tc_kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, Tq, Tk, make_strides(strides), scale);
  return cudaGetLastError();
}
