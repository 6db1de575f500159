// Flash attention forward at head width 512 on the tensor cores of Hopper
// (sm_90a), bfloat16, plain C interface.
//
// Replaces the TPU kernel tair_tpu/ops/flash_attention.py::_flash_kernel
// (driven by _flash_forward) at the autoencoder's head width: the single-head
// middle attention of the VAE's encoder and decoder, T = 4096 at 512 x 512.
// Outputs O (bf16) and the per-row logsumexp (float, natural log), the same
// function as flash_attention_tc.cu (D <= 128) and flash_attention.cu (which
// keeps float32).
//
// Bound on this card: operations (4*Tq*Tk*512 flops over a few T*512 values).
// flash_attention_tc.cu's layout, where a warp owns 16 query rows for every
// column, does not widen to D = 512: one warp's O accumulator would be 256
// floats a thread, its q fragments 128 registers, and 64-query blocks give 64
// blocks at H = 1 for 132 SMs.
//
// Design: the logits are shared across the warps, and each warp owns a slice
// of the output columns. mma.sync m16n8k16, bf16 operands, float accumulators.
// One block of 8 warps per (batch*head, 32 queries): 128 blocks at T = 4096.
// Tiles of 32 keys of K and V go through a two-stage cp.async ring. Per tile:
//   S = q K^T   each warp forms a partial S of 16 rows x 32 keys over a quarter
//               of D (2 row groups x 4 quarters), its q fragments (32
//               registers) loaded once, K by ldmatrix; the partials meet in
//               shared memory, and each warp adds the four quarters, in order,
//               of its 16 rows x 8 keys;
//   softmax     each warp's row maxima go to shared memory, every thread
//               combines the four key groups of its rows in one order (so all
//               warps hold the same running max), P = exp2(S - max) goes to
//               shared memory as two bf16 terms (hi + lo) with its row sums;
//   O += P V    each warp owns 64 output columns for all 32 rows (2 m-tiles x 8
//               n-tiles, 64 floats a thread), P by ldmatrix and V by
//               ldmatrix.trans; P enters as hi + lo, two products, because one
//               bf16 P fails the elementwise tolerance of outputs near 0 (the
//               CPU emulation in tests/test_torch_flash_attention.py).
// Per tile and SM, 64 KB land by cp.async and the fragments read back from
// shared memory are 64 KB of K, 32 KB of partial S and 64 KB of P and V. The
// split over D holds q in registers: in a first design every warp reduced over
// all of D for 8 keys and read q from shared memory four times a tile; it took
// 0.355 ms of device time at T = 4096, this one 0.326 (H100 80GB HBM3, 700 W).
// So shared-memory reads are not all of the cost: with 8 warps an SM and four
// barriers a tile, latency is the rest. The four __syncthreads of a tile: the
// tile has landed (which also frees the stage refilled next), the partial S,
// the row maxima, P. Shared memory is 186.5 KB: one block per SM. No atomics;
// deterministic. Keys past Tk get a finite -1e30 before the max (p = 0, never
// NaN); rows past Tq are loaded as zeros and not stored. The [B, T, H, D]
// strides are taken as given: rows must be 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
constexpr int kD = 512;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 32;              // queries per block: two 16-row groups
constexpr int kBK = 32;              // keys per tile: four 8-key groups
constexpr int kCols = kD / kWarps;   // output columns per warp
constexpr int kDQuarter = kD / 4;    // columns of q and K in a warp's partial S
constexpr int kLD = kD + 8;          // row pitch of the q, K, V tiles
constexpr int kLDP = kBK + 8;        // row pitch of the P tiles
constexpr int kLDS = kBK + 4;        // row pitch of the partial S, in floats
constexpr int kQElems = kBQ * kLD;
constexpr int kKVElems = kBK * kLD;
constexpr int kPElems = kBQ * kLDP;
constexpr int kSmemBytes =
    (kQElems + 4 * kKVElems + 2 * kPElems) * static_cast<int>(sizeof(bf16)) +
    (4 * kBQ * kLDS + 2 * 4 * kBQ) * static_cast<int>(sizeof(float));
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int Tq, int Tk,
                         int64_t q_sb, int64_t q_st, int64_t q_sh,
                         int64_t k_sb, int64_t k_st, int64_t k_sh,
                         int64_t v_sb, int64_t v_st, int64_t v_sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kQElems;        // two stages
  bf16* Vs = Ks + 2 * kKVElems;   // two stages
  bf16* Ph = Vs + 2 * kKVElems;   // P, high bf16 term
  bf16* Pl = Ph + kPElems;        // P, low bf16 term
  float* red_s = reinterpret_cast<float*>(Pl + kPElems);  // [D quarter][row][key]
  float* red_max = red_s + 4 * kBQ * kLDS;                 // [key group][row]
  float* red_sum = red_max + 4 * kBQ;                      // [key group][row]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
  const int rg = warp >> 2;  // row group of the warp's S tile
  const int kg = warp & 3;   // key group of the warp's S tile
  const int dq = warp & 3;   // quarter of D of the warp's partial S
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
    tc::load_rows_async(Ks + stage * kKVElems, kLD, kp + row * k_st, k_st, kBK, valid, kD,
                        kThreads);
    tc::load_rows_async(Vs + stage * kKVElems, kLD, vp + row * v_st, v_st, kBK, valid, kD,
                        kThreads);
  };
  tc::load_rows_async(Qs, kLD, qp, q_st, kBQ, min(kBQ, Tq - q0), kD, kThreads);
  load_kv(0);
  tc::cp_async_commit();

  // O for rows mt*16 + g (+ 8) and columns warp*64 + j*8 + c (+ 1)
  float acc[2][kCols / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  // running max (log2 units) and sum of the thread's four rows g, g + 8,
  // 16 + g, 24 + g (index r = 2 * m-tile + half); every warp holds the same
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  uint32_t qf[kDQuarter / 16][4];  // q rows rg*16.., columns dq*128.., as A fragments

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t is in shared memory, and every warp is done with tile t-1
    if (t + 1 < n_tiles) {
      load_kv(t + 1);  // into the stage tile t-1 used
      tc::cp_async_commit();
    }
    const bf16* Kt = Ks + (t & 1) * kKVElems;
    const bf16* Vt = Vs + (t & 1) * kKVElems;

    // partial S over the warp's quarter of D: rows rg*16 + g (+ 8), all 32
    // keys, q from registers and K by ldmatrix
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kDQuarter / 16; ++kk)
        tc::ldmatrix_x4(qf[kk], tc::a_rows(Qs, kLD, rg * 16, dq * kDQuarter + kk * 16, lane));
    }
    float sp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDQuarter / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, tc::b_rows(Kt, kLD, np * 16, dq * kDQuarter + kk * 16, lane));
        tc::mma(sp[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma(sp[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(red_s + (dq * kBQ + rg * 16 + g + 8 * i) * kLDS + j * 8 + c) =
            make_float2(sp[j][2 * i], sp[j][2 * i + 1]);
    __syncthreads();  // every quarter's partial S

    // S for rows rg*16 + g (+ 8) and keys kg*8 + c (+ 1): the four quarters
    // added in order
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int part = 0; part < 4; ++part)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x = *reinterpret_cast<const float2*>(
            red_s + (part * kBQ + rg * 16 + g + 8 * i) * kLDS + kg * 8 + c);
        s[2 * i] += x.x;
        s[2 * i + 1] += x.y;
      }
    const int key0 = t * kBK + kg * 8 + c;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = key0 + (e & 1) < Tk;
      s[e] = ok ? s[e] * scale_log2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if ((lane & 3) == 0) red_max[kg * kBQ + rg * 16 + g + 8 * i] = mx[i];
    }
    __syncthreads();  // every key group's row maxima

    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r >> 1) * 16 + g + 8 * (r & 1);
      float m = m_run[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) m = fmaxf(m, red_max[j * kBQ + row]);
      alpha[r] = exp2f(m_run[r] - m);
      m_run[r] = m;
    }
    // P of the warp's S tile, as hi + lo, and its row sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rg * 16 + g + 8 * i;
      const float m = m_run[2 * rg + i];
      const float p0 = exp2f(s[2 * i] - m);
      const float p1 = exp2f(s[2 * i + 1] - m);
      uint32_t hi, lo;
      tc::split(p0, p1, hi, lo);
      *reinterpret_cast<uint32_t*>(Ph + row * kLDP + kg * 8 + c) = hi;
      *reinterpret_cast<uint32_t*>(Pl + row * kLDP + kg * 8 + c) = lo;
      float sum = p0 + p1;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((lane & 3) == 0) red_sum[kg * kBQ + row] = sum;
    }
    __syncthreads();  // P and its row sums

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r >> 1) * 16 + g + 8 * (r & 1);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += red_sum[j * kBQ + row];
      l_run[r] = l_run[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] *= alpha[2 * mt + (e >> 1)];

    // O += P V over the warp's 64 columns, P as two bf16 terms
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        tc::ldmatrix_x4(ph[mt], tc::a_rows(Ph, kLDP, mt * 16, ks * 16, lane));
        tc::ldmatrix_x4(pl[mt], tc::a_rows(Pl, kLDP, mt * 16, ks * 16, lane));
      }
#pragma unroll
      for (int dp = 0; dp < kCols / 16; ++dp) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, tc::a_rows(Vt, kLD, ks * 16, warp * kCols + dp * 16, lane));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          tc::mma(acc[mt][2 * dp], ph[mt], vb[0], vb[1]);
          tc::mma(acc[mt][2 * dp + 1], ph[mt], vb[2], vb[3]);
          tc::mma(acc[mt][2 * dp], pl[mt], vb[0], vb[1]);
          tc::mma(acc[mt][2 * dp + 1], pl[mt], vb[2], vb[3]);
        }
      }
    }
  }

  // epilogue: O = acc / l, lse = m + log(l) in natural-log units
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + (r >> 1) * 16 + g + 8 * (r & 1);
    if (row >= Tq) continue;
    const float inv = 1.f / l_run[r];
    const int mt = r >> 1;
    const int i = r & 1;
    bf16* op = o + ((static_cast<int64_t>(b) * Tq + row) * H + h) * kD + warp * kCols + c;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(acc[mt][j][2 * i] * inv, acc[mt][j][2 * i + 1] * inv);
    if (warp == 0 && (lane & 3) == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Tq + row] = m_run[r] * kLn2 + logf(l_run[r]);
  }
}

}  // namespace

// q [B, Tq, H, 512], k and v [B, Tk, H, 512], bfloat16, with unit stride along
// D, rows 16-byte aligned and the element strides (batch, token, head) of q, k,
// v in strides[0..8]; o [B, Tq, H, 512] bfloat16 contiguous; lse [B, H, Tq]
// float. Returns the CUDA error code of the launch (0 on success), -1 for a
// head width other than 512.
extern "C" int flash_attention_fwd_wide_tc(const void* q, const void* k, const void* v,
                                           void* o, float* lse, int B, int H, int Tq,
                                           int Tk, int D, const int64_t* st, float scale,
                                           void* stream) {
  if (D != kD) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_wide_tc_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale);
  return cudaGetLastError();
}
