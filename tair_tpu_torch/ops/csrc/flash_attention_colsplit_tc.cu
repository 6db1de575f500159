// Flash attention at head widths above 512 on the tensor cores of Hopper
// (sm_90a), bfloat16, plain C interface: the forward, dQ, and dK with dV.
//
// Replaces the TPU kernels tair_tpu/ops/flash_attention.py::_flash_kernel
// (driven by _flash_forward), ::_flash_dq_kernel and ::_flash_dkv_kernel
// (driven by _flash_attention_bwd) at the head widths the Pallas kernel takes
// and flash_attention_wide_tc.cu / flash_attention_wide_bwd_tc.cu (D = 512)
// do not: an autoencoder whose middle width ch * ch_mult[-1] passes 512, a
// UNet whose num_head_channels does. The wrapper pads D with zeros to a
// multiple of 128 (the caller's scale, so the zeros change no logit); the
// same functions as the D = 512 kernels: O (bf16) and the per-row logsumexp
// (float, natural log); dQ = dS k, dK = dS^T q and dV = P^T dO with P rebuilt
// from lse and dS = P * (dP - delta) * scale (delta = rowsum(dO * O), float
// [B, H, Tq] from the wrapper). flash_attention_colsplit.cu keeps float32.
//
// Bound on this card: operations, as at D = 512 (4, 6 and 8 * Tq * Tk * D
// flops over a few T * D values).
//
// Why not the D = 512 design, widened: its q fragments sit in registers, its
// key tiles hold every column and each warp owns 64 output columns of 32
// rows. At D = 1024 the tiles alone pass the 227 KB a block may have, and one
// 32-row float accumulator over all of D is 128 KB. So here a block owns a
// slice of at most 512 output columns, and D is streamed:
//   grid     a block per (32 resident rows, batch*head, column slice); the
//            D / 128 units of 128 columns are shared out over ceil(D / 512)
//            slices as evenly as they go (slice_of; ops/flash_attention.py::
//            column_slices is the same rule), so each warp owns 16 * units
//            (32, 48 or 64) columns of its slice;
//   S, dP    over the whole of D: 128-column chunks of the resident rows and
//            of a 32-row streamed tile go through a three-stage cp.async ring
//            (the resident chunks are read again for every tile: shared
//            memory does not grow with D). Each warp forms 16 rows x 8
//            columns of S (and of dP) over all of D, in one fixed order, in
//            two or four accumulator chains added at the end: every slice
//            computes the same logits, running max and row sums bit for bit;
//   softmax  the D = 512 kernel's (row maxima and sums met in shared memory,
//            P = exp2(S - max) as hi + lo bf16 terms); in the backward P and
//            dS as hi + lo (the two-term rule of
//            tests/test_torch_flash_attention.py);
//   output   O += P V, dQ += dS K, dV += P^T dO, dK += dS^T q over the slice
//            only: the slice of the streamed tile is loaded once per tile,
//            read by ldmatrix.trans.
// The split recomputes S (and dP) once per slice: at D = 1024, two slices,
// the forward does 1.5 x the function's products, dQ 1.67 x, dK/dV 1.5 x.
// Slice 0 alone stores the logsumexp. No atomics; every output is stored
// once; deterministic. Keys past Tk get P = 0 (never NaN); rows past Tq are
// loaded as zeros, masked to P = 0 in dK/dV, and not stored. The [B, T, H, D]
// strides are taken as given: rows must be 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kB = 32;          // resident rows per block, streamed rows per tile
constexpr int kChunk = 128;     // columns of D per streamed chunk, and the width granule
constexpr int kStages = 3;      // chunks in flight
constexpr int kSliceMax = 512;  // output columns of a block, at most
constexpr int kLDC = kChunk + 8;     // row pitch of a chunk
constexpr int kLDV = kSliceMax + 8;  // row pitch of a slice tile
constexpr int kLDP = kB + 8;         // row pitch of the P and dS tiles
constexpr int kChunkElems = kB * kLDC;
constexpr int kSliceElems = kB * kLDV;
constexpr int kPElems = kB * kLDP;
constexpr int kChunkBytes = kChunkElems * static_cast<int>(sizeof(bf16));
constexpr int kSliceBytes = kSliceElems * static_cast<int>(sizeof(bf16));
constexpr int kPBytes = kPElems * static_cast<int>(sizeof(bf16));
// forward: chunks of q and K, the V slice, P as two terms, row maxima and sums
constexpr int kFwdSmem = 2 * kStages * kChunkBytes + kSliceBytes + 2 * kPBytes +
                         2 * 4 * kB * static_cast<int>(sizeof(float));
// dQ: chunks of q, dO, K, V, the K slice, dS as two terms
constexpr int kDqSmem = 4 * kStages * kChunkBytes + kSliceBytes + 2 * kPBytes;
// dK/dV: chunks of K, V, q, dO, the q and dO slices, P and dS as two terms each
constexpr int kDkvSmem = 4 * kStages * kChunkBytes + 2 * kSliceBytes + 4 * kPBytes;
static_assert(kDkvSmem <= 232448, "dK/dV passes the shared memory of a block");
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  int64_t q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, do_b, do_t, do_h;
};

// Output slice s of n over D / 128 units: its first column and its units.
struct Slice {
  int start, units;
};
__device__ inline Slice slice_of(int D, int s, int n) {
  const int units = D / kChunk;
  const int base = units / n;
  const int rem = units - base * n;
  return Slice{kChunk * (s * base + min(s, rem)), base + (s < rem ? 1 : 0)};
}

// Row addresses for ldmatrix_x4 (non-trans) of the B operands of two 16-deep
// steps from an [n][k] tile: matrices (n 0-7, k 0-7), (k 8-15), (k 16-23),
// (k 24-31) give b0, b1 of the step at col0 and b0, b1 of the step at
// col0 + 16, for the 8-row n-tile at row0.
__device__ inline const bf16* b_rows8(const bf16* tile, int ld, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7)) * ld + col0 + (lane >> 3) * 8;
}

// acc[chain] += A B^T over one chunk for the warp's 16 rows (rg) and 8
// columns (kg): A and B are [row][d] chunks; step kk of the chunk's eight
// 16-deep steps goes to chain kk % NCH.
template <int NCH>
__device__ inline void chunk_product(const bf16* A, const bf16* B, int rg, int kg, int lane,
                                     float (&acc)[NCH][4]) {
#pragma unroll
  for (int kp = 0; kp < kChunk / 32; ++kp) {
    uint32_t b[4];
    tc::ldmatrix_x4(b, b_rows8(B, kLDC, kg * 8, kp * 32, lane));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, tc::a_rows(A, kLDC, rg * 16, kp * 32 + half * 16, lane));
      tc::mma(acc[(2 * kp + half) % NCH], a, b[2 * half], b[2 * half + 1]);
    }
  }
}

// The chains added in one order: the whole product of the warp's fragment.
template <int NCH>
__device__ inline void sum_chains(float (&acc)[NCH][4], float (&out)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float x = acc[0][e];
#pragma unroll
    for (int ch = 1; ch < NCH; ++ch) x += acc[ch][e];
    out[e] = x;
  }
}

template <int NCH>
__device__ inline void zero_chains(float (&acc)[NCH][4]) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ch][e] = 0.f;
}

__device__ inline void zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

// acc += A B over one 32-deep tile for the warp's 16 * units columns of the
// slice: A (32 x 32) as hi + lo bf16 tiles, B a [32][slice] tile read by
// ldmatrix.trans.
__device__ inline void slice_product(float (&acc)[2][8][4], const bf16* Ah, const bf16* Al,
                                     const bf16* Bt, int units, int warp, int lane) {
  const int col0 = warp * units * 16;
#pragma unroll
  for (int ks = 0; ks < kB / 16; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      tc::ldmatrix_x4(ah[mt], tc::a_rows(Ah, kLDP, mt * 16, ks * 16, lane));
      tc::ldmatrix_x4(al[mt], tc::a_rows(Al, kLDP, mt * 16, ks * 16, lane));
    }
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      if (dp >= units) break;
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, tc::a_rows(Bt, kLDV, ks * 16, col0 + dp * 16, lane));
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

// Rows row0 + mt*16 + g (+ 8) of the warp's columns of the slice, times
// mul[r] (r = 2 * mt + half), in bf16; rows at or past `rows` are skipped.
// `out` points at row 0, column 0 of the slice.
__device__ inline void store_slice(const float (&acc)[2][8][4], const float (&mul)[4], bf16* out,
                                   int64_t row_stride, int row0, int rows, int units, int warp,
                                   int g, int c) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int mt = r >> 1;
    const int i = r & 1;
    const int row = row0 + mt * 16 + g + 8 * i;
    if (row >= rows) continue;
    bf16* op = out + static_cast<int64_t>(row) * row_stride + warp * units * 16 + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= 2 * units) break;
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(acc[mt][j][2 * i] * mul[r], acc[mt][j][2 * i + 1] * mul[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: a block per (32 queries, batch*head, slice); K streams. Two
// blocks an SM (89.5 KB of shared memory each).
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_colsplit_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int H, int Tq, int Tk, int D,
                             Strides st, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qc = reinterpret_cast<bf16*>(smem_raw);  // kStages chunks of q
  bf16* Kc = Qc + kStages * kChunkElems;          // kStages chunks of K
  bf16* Vs = Kc + kStages * kChunkElems;          // the tile's V slice
  bf16* Ph = Vs + kSliceElems;                    // P, high bf16 term
  bf16* Pl = Ph + kPElems;                        // P, low bf16 term
  float* red_max = reinterpret_cast<float*>(Pl + kPElems);  // [key group][row]
  float* red_sum = red_max + 4 * kB;                         // [key group][row]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
  const int rg = warp >> 2;  // row group of the warp's S tile
  const int kg = warp & 3;   // key group of the warp's S tile
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kB;
  const Slice sl = slice_of(D, blockIdx.z, gridDim.z);
  const bf16* qp = q + b * st.q_b + h * st.q_h + static_cast<int64_t>(q0) * st.q_t;
  const bf16* kp = k + b * st.k_b + h * st.k_h;
  const bf16* vp = v + b * st.v_b + h * st.v_h + sl.start;
  const int q_valid = min(kB, Tq - q0);
  const int n_chunks = D / kChunk;
  const int n_tiles = (Tk + kB - 1) / kB;
  const int steps = n_tiles * n_chunks;

  // step n = tile * n_chunks + chunk: chunk `chunk` of q and of the tile's keys
  auto load_step = [&](int n) {
    if (n < steps) {
      const int t = n / n_chunks;
      const int col = (n - t * n_chunks) * kChunk;
      const int stage = n % kStages;
      tc::load_rows_async(Qc + stage * kChunkElems, kLDC, qp + col, st.q_t, kB, q_valid, kChunk,
                          kThreads);
      tc::load_rows_async(Kc + stage * kChunkElems, kLDC,
                          kp + static_cast<int64_t>(t) * kB * st.k_t + col, st.k_t, kB,
                          min(kB, Tk - t * kB), kChunk, kThreads);
    }
    tc::cp_async_commit();
  };
  load_step(0);
  load_step(1);

  float acc[2][8][4];
  zero(acc);
  // running max (log2 units) and sum of the thread's rows g, g + 8, 16 + g,
  // 24 + g (r = 2 * m-tile + half); every warp, and every slice, holds the same
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    float chains[4][4];
    zero_chains(chains);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int n = t * n_chunks + ch;
      tc::cp_async_wait<1>();
      __syncthreads();  // step n is in shared memory; every warp is done with step n-1
      if (ch == 0)      // the tile's V slice joins step n + 2's group (n_chunks >= 5)
        tc::load_rows_async(Vs, kLDV, vp + static_cast<int64_t>(t) * kB * st.v_t, st.v_t, kB,
                            min(kB, Tk - t * kB), sl.units * kChunk, kThreads);
      load_step(n + 2);  // into the stage step n-1 used
      const int stage = n % kStages;
      chunk_product(Qc + stage * kChunkElems, Kc + stage * kChunkElems, rg, kg, lane, chains);
    }
    float s[4];
    sum_chains(chains, s);

    // S for rows rg*16 + g (+ 8) and keys kg*8 + c (+ 1): mask, row maxima
    const int key0 = t * kB + kg * 8 + c;
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
      if ((lane & 3) == 0) red_max[kg * kB + rg * 16 + g + 8 * i] = mx[i];
    }
    __syncthreads();  // every key group's row maxima

    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r >> 1) * 16 + g + 8 * (r & 1);
      float m = m_run[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) m = fmaxf(m, red_max[j * kB + row]);
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
      if ((lane & 3) == 0) red_sum[kg * kB + row] = sum;
    }
    __syncthreads();  // P and its row sums (the V slice landed at step 2 of the tile)

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r >> 1) * 16 + g + 8 * (r & 1);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += red_sum[j * kB + row];
      l_run[r] = l_run[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] *= alpha[2 * mt + (e >> 1)];
    slice_product(acc, Ph, Pl, Vs, sl.units, warp, lane);  // O += P V over the slice
  }
  tc::cp_async_wait<0>();

  // epilogue: O = acc / l over the slice; slice 0 stores lse = m + log(l)
  float inv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) inv[r] = 1.f / l_run[r];
  store_slice(acc, inv, o + (static_cast<int64_t>(b) * Tq * H + h) * D + sl.start,
              static_cast<int64_t>(H) * D, q0, Tq, sl.units, warp, g, c);
  if (blockIdx.z == 0 && warp == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + (r >> 1) * 16 + g + 8 * (r & 1);
      if (row < Tq)
        lse[(static_cast<int64_t>(b) * H + h) * Tq + row] = m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: a block per (32 queries, batch*head, slice); K and V stream.
__global__ void __launch_bounds__(kThreads)
flash_dq_colsplit_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dO,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dq, int H, int Tq, int Tk, int D, Strides st,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qc = reinterpret_cast<bf16*>(smem_raw);  // kStages chunks each of q, dO, K, V
  bf16* dOc = Qc + kStages * kChunkElems;
  bf16* Kc = dOc + kStages * kChunkElems;
  bf16* Vc = Kc + kStages * kChunkElems;
  bf16* Ks = Vc + kStages * kChunkElems;  // the tile's K slice
  bf16* dSh = Ks + kSliceElems;
  bf16* dSl = dSh + kPElems;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
  const int rg = warp >> 2;  // row group of the warp's S and dP tiles
  const int kg = warp & 3;   // key group of the warp's S and dP tiles
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kB;
  const Slice sl = slice_of(D, blockIdx.z, gridDim.z);
  const bf16* qp = q + b * st.q_b + h * st.q_h + static_cast<int64_t>(q0) * st.q_t;
  const bf16* dop = dO + b * st.do_b + h * st.do_h + static_cast<int64_t>(q0) * st.do_t;
  const bf16* kp = k + b * st.k_b + h * st.k_h;
  const bf16* vp = v + b * st.v_b + h * st.v_h;
  const int q_valid = min(kB, Tq - q0);
  const int n_chunks = D / kChunk;
  const int n_tiles = (Tk + kB - 1) / kB;
  const int steps = n_tiles * n_chunks;

  auto load_step = [&](int n) {
    if (n < steps) {
      const int t = n / n_chunks;
      const int col = (n - t * n_chunks) * kChunk;
      const int at = (n % kStages) * kChunkElems;
      const int valid = min(kB, Tk - t * kB);
      const int64_t key = static_cast<int64_t>(t) * kB;
      tc::load_rows_async(Qc + at, kLDC, qp + col, st.q_t, kB, q_valid, kChunk, kThreads);
      tc::load_rows_async(dOc + at, kLDC, dop + col, st.do_t, kB, q_valid, kChunk, kThreads);
      tc::load_rows_async(Kc + at, kLDC, kp + key * st.k_t + col, st.k_t, kB, valid, kChunk,
                          kThreads);
      tc::load_rows_async(Vc + at, kLDC, vp + key * st.v_t + col, st.v_t, kB, valid, kChunk,
                          kThreads);
    }
    tc::cp_async_commit();
  };
  load_step(0);
  load_step(1);

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

  float acc[2][8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    float s_chains[2][4], dp_chains[2][4];
    zero_chains(s_chains);
    zero_chains(dp_chains);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int n = t * n_chunks + ch;
      tc::cp_async_wait<1>();
      __syncthreads();  // step n is in shared memory; every warp is done with step n-1
      if (ch == 0)
        tc::load_rows_async(Ks, kLDV, kp + static_cast<int64_t>(t) * kB * st.k_t + sl.start,
                            st.k_t, kB, min(kB, Tk - t * kB), sl.units * kChunk, kThreads);
      load_step(n + 2);
      const int at = (n % kStages) * kChunkElems;
      chunk_product(Qc + at, Kc + at, rg, kg, lane, s_chains);
      chunk_product(dOc + at, Vc + at, rg, kg, lane, dp_chains);
    }
    float s[4], dp[4];
    sum_chains(s_chains, s);
    sum_chains(dp_chains, dp);

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
    __syncthreads();  // dS (the K slice landed at step 2 of the tile)

    slice_product(acc, dSh, dSl, Ks, sl.units, warp, lane);  // dQ += dS K over the slice
  }
  tc::cp_async_wait<0>();
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_slice(acc, one, dq + (static_cast<int64_t>(b) * Tq * H + h) * D + sl.start,
              static_cast<int64_t>(H) * D, q0, Tq, sl.units, warp, g, c);
}

// ---------------------------------------------------------------------------
// dK, dV: a block per (32 keys, batch*head, slice); q, dO, lse and delta stream.
__global__ void __launch_bounds__(kThreads)
flash_dkv_colsplit_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dO,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq,
                             int Tk, int D, Strides st, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Kc = reinterpret_cast<bf16*>(smem_raw);  // kStages chunks each of K, V, q, dO
  bf16* Vc = Kc + kStages * kChunkElems;
  bf16* Qc = Vc + kStages * kChunkElems;
  bf16* dOc = Qc + kStages * kChunkElems;
  bf16* Qs = dOc + kStages * kChunkElems;  // the tile's q slice
  bf16* dOs = Qs + kSliceElems;            // the tile's dO slice
  bf16* Ph = dOs + kSliceElems;            // P^T [key][query]
  bf16* Pl = Ph + kPElems;
  bf16* dSh = Pl + kPElems;                // dS^T [key][query]
  bf16* dSl = dSh + kPElems;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
  const int rg = warp >> 2;  // key group of the warp's S^T and dP^T tiles
  const int qg = warp & 3;   // query group of the warp's S^T and dP^T tiles
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kB;
  const Slice sl = slice_of(D, blockIdx.z, gridDim.z);
  const bf16* kp = k + b * st.k_b + h * st.k_h + static_cast<int64_t>(k0) * st.k_t;
  const bf16* vp = v + b * st.v_b + h * st.v_h + static_cast<int64_t>(k0) * st.v_t;
  const bf16* qp = q + b * st.q_b + h * st.q_h;
  const bf16* dop = dO + b * st.do_b + h * st.do_h;
  const float* lsep = lse + (static_cast<int64_t>(b) * H + h) * Tq;
  const float* deltap = delta + (static_cast<int64_t>(b) * H + h) * Tq;
  const int k_valid = min(kB, Tk - k0);
  const int n_chunks = D / kChunk;
  const int n_tiles = (Tq + kB - 1) / kB;
  const int steps = n_tiles * n_chunks;

  auto load_step = [&](int n) {
    if (n < steps) {
      const int t = n / n_chunks;
      const int col = (n - t * n_chunks) * kChunk;
      const int at = (n % kStages) * kChunkElems;
      const int valid = min(kB, Tq - t * kB);
      const int64_t query = static_cast<int64_t>(t) * kB;
      tc::load_rows_async(Kc + at, kLDC, kp + col, st.k_t, kB, k_valid, kChunk, kThreads);
      tc::load_rows_async(Vc + at, kLDC, vp + col, st.v_t, kB, k_valid, kChunk, kThreads);
      tc::load_rows_async(Qc + at, kLDC, qp + query * st.q_t + col, st.q_t, kB, valid, kChunk,
                          kThreads);
      tc::load_rows_async(dOc + at, kLDC, dop + query * st.do_t + col, st.do_t, kB, valid,
                          kChunk, kThreads);
    }
    tc::cp_async_commit();
  };
  load_step(0);
  load_step(1);
  const float scale_log2 = scale * kLog2e;

  float acc_k[2][8][4], acc_v[2][8][4];
  zero(acc_k);
  zero(acc_v);

  for (int t = 0; t < n_tiles; ++t) {
    const int q_valid = min(kB, Tq - t * kB);
    float s_chains[2][4], dp_chains[2][4];
    zero_chains(s_chains);
    zero_chains(dp_chains);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int n = t * n_chunks + ch;
      tc::cp_async_wait<1>();
      __syncthreads();  // step n is in shared memory; every warp is done with step n-1
      if (ch == 0) {
        const int64_t query = static_cast<int64_t>(t) * kB;
        tc::load_rows_async(Qs, kLDV, qp + query * st.q_t + sl.start, st.q_t, kB, q_valid,
                            sl.units * kChunk, kThreads);
        tc::load_rows_async(dOs, kLDV, dop + query * st.do_t + sl.start, st.do_t, kB, q_valid,
                            sl.units * kChunk, kThreads);
      }
      load_step(n + 2);
      const int at = (n % kStages) * kChunkElems;
      chunk_product(Kc + at, Qc + at, rg, qg, lane, s_chains);   // S^T = K q^T
      chunk_product(Vc + at, dOc + at, rg, qg, lane, dp_chains);  // dP^T = V dO^T
    }
    float s[4], dp[4];
    sum_chains(s_chains, s);
    sum_chains(dp_chains, dp);

    const int qi = qg * 8 + c;  // the thread's queries qi, qi + 1 of the tile
    float lse2[2], dl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = qi + e < q_valid;
      lse2[e] = ok ? lsep[t * kB + qi + e] * kLog2e : 0.f;
      dl[e] = ok ? deltap[t * kB + qi + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = qi + e < q_valid ? exp2f(s[2 * i + e] * scale_log2 - lse2[e]) : 0.f;
        ds[e] = p[e] * (dp[2 * i + e] - dl[e]) * scale;
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
    __syncthreads();  // P^T and dS^T (the q and dO slices landed at step 2 of the tile)

    slice_product(acc_v, Ph, Pl, dOs, sl.units, warp, lane);  // dV += P^T dO
    slice_product(acc_k, dSh, dSl, Qs, sl.units, warp, lane);  // dK += dS^T q
  }
  tc::cp_async_wait<0>();
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const int64_t head = (static_cast<int64_t>(b) * Tk * H + h) * D + sl.start;
  store_slice(acc_k, one, dk + head, static_cast<int64_t>(H) * D, k0, Tk, sl.units, warp, g, c);
  store_slice(acc_v, one, dv + head, static_cast<int64_t>(H) * D, k0, Tk, sl.units, warp, g, c);
}

Strides make_strides(const int64_t* s, bool backward) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                 backward ? s[9] : 0, backward ? s[10] : 0, backward ? s[11] : 0};
}

// a head width these kernels take: above 512, a multiple of 128
bool takes(int D) { return D > kSliceMax && D % kChunk == 0; }

dim3 grid_of(int rows, int B, int H, int D) {
  return dim3((rows + kB - 1) / kB, B * H, (D / kChunk + 3) / 4);
}

}  // namespace

// q [B, Tq, H, D], k and v [B, Tk, H, D], bfloat16, D above 512 and a
// multiple of 128, with unit stride along D, rows 16-byte aligned and the
// element strides (batch, token, head) of q, k, v in strides[0..8]; o
// [B, Tq, H, D] bfloat16 contiguous; lse [B, H, Tq] float. Returns the CUDA
// error code of the launch (0 on success), -1 for a head width these kernels
// do not take.
extern "C" int flash_attention_fwd_colsplit_tc(const void* q, const void* k, const void* v,
                                               void* o, float* lse, int B, int H, int Tq,
                                               int Tk, int D, const int64_t* strides,
                                               float scale, void* stream) {
  if (!takes(D)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_colsplit_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_colsplit_tc_kernel<<<grid_of(Tq, B, H, D), kThreads, kFwdSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, Tq, Tk, D, make_strides(strides, false), scale);
  return cudaGetLastError();
}

// As flash_attention_fwd_colsplit_tc, with dO [B, Tq, H, D] (its strides in
// strides[9..11]), lse and delta [B, H, Tq] float contiguous; dq [B, Tq, H, D]
// bfloat16 contiguous.
extern "C" int flash_attention_dq_colsplit_tc(const void* q, const void* k, const void* v,
                                              const void* dO, const float* lse,
                                              const float* delta, void* dq, int B, int H,
                                              int Tq, int Tk, int D, const int64_t* strides,
                                              float scale, void* stream) {
  if (!takes(D)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_colsplit_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  flash_dq_colsplit_tc_kernel<<<grid_of(Tq, B, H, D), kThreads, kDqSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dq), H, Tq, Tk, D,
      make_strides(strides, true), scale);
  return cudaGetLastError();
}

// As flash_attention_dq_colsplit_tc; dk, dv [B, Tk, H, D] bfloat16 contiguous.
extern "C" int flash_attention_dkv_colsplit_tc(const void* q, const void* k, const void* v,
                                               const void* dO, const float* lse,
                                               const float* delta, void* dk, void* dv, int B,
                                               int H, int Tq, int Tk, int D,
                                               const int64_t* strides, float scale,
                                               void* stream) {
  if (!takes(D)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_colsplit_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_dkv_colsplit_tc_kernel<<<grid_of(Tk, B, H, D), kThreads, kDkvSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, Tq, Tk, D, make_strides(strides, true), scale);
  return cudaGetLastError();
}
