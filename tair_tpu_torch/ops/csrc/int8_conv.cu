// int8 implicit-GEMM convolution with the w8a8 rescale in its epilogue (Q1 of
// the w8a8 serving path) for Hopper (sm_90a), plain C interface; and the entry
// of a whole quantized site, Q2 (quant_act.cu, the same library) then Q1.
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
// or, with T = int32 (out_dtype 2), out = acc: the accumulators without the
// epilogue, which a row-parallel site under tensor parallelism (parallel/tp.py)
// sums over the model axis before it rescales them (ops/quant.py::_rescale,
// bit-equal to this epilogue).
// with xscale = stats[1], read on the device. A dense layer is the 1 x 1 case
// over its tokens (B = tokens, H = W = 1).
//
// Bound on this card: operations at the UNet's wide sites (int8 tensor cores,
// 1,979 TOP/s dense), the weight's bytes at the few-row ones (M = 64-256 at
// the inner levels, 77 context tokens). The design, for the H100:
//   - The GEMM is M = B*Ho*Wo rows, N = O, K = KH*KW*Cp; both operands are
//     K-major already (x8's channels innermost, w8's rows), the one layout
//     wgmma takes for 8-bit types. A block owns a 128 x BN output tile (BN 32,
//     160 or 256, chosen with the split by ops/quant.py::conv_schedule).
//   - Warpgroups 0 and 1 consume: each runs wgmma.mma_async m64nBNk32 s8 on
//     its 64 rows, both operands read from shared memory through descriptors
//     of the 128-byte swizzle, the int32 sums in registers.
//   - Warpgroup 2 produces a ring of 4 stages, each 128 bytes of K. Its first
//     thread loads the weight tile by TMA (a tiled tensor map over [O, K] with
//     that swizzle; zeros past O and K); its 128 threads gather the
//     activation's im2col rows with cp.async 16-byte pieces written into the
//     same swizzled layout by hand (zero outside the image and past K). A tap
//     never splits a piece (Cp % 16 == 0), so a piece is one copy. Each stage
//     has a "full" mbarrier (128 cp.async arrivals and the TMA bytes) and an
//     "empty" one (the 8 consumer warps). The im2col position of a thread's
//     piece advances by additions, with no division after the block's start.
//     At a 1 x 1, stride 1, unpadded product (the dense layers, the 1 x 1
//     convolutions) the activation is a plain [M, K] matrix: the first thread
//     loads its tile by TMA as well, and the stage's barrier waits on bytes
//     alone.
//   - When the tiles do not fill the card, K is split over the blocks of the
//     one launch (gridDim.z, at most 8), and a tile's splits form one thread
//     block cluster: each stages its int32 sums in its shared memory, and
//     after a cluster barrier each sums all of the splits' tiles, through
//     distributed shared memory, over its own slice of the rows and writes
//     that slice's output. No workspace, no atomics, no second launch.
//     (Adding the splits in global memory, by per-element atomics or one TMA
//     reduce a block, was tried first and was slower: PERF.md.) Integer sums
//     do not depend on their order, so every split gives the same bits.
//   - The epilogue uses __fmul_rn / __fadd_rn and rounds to T before the bias
//     add (no FMA contraction), so the output equals the plain version's
//     (float64 im2col product, ops/quant.py) bit for bit. Each column's
//     factors (wscale * xscale, the bias) are read into shared memory once a
//     block; an unsplit tile is staged in shared memory and written in rows
//     of 16-byte stores.
// Where it stands (PERF.md): ahead of bf16 cuDNN at the 3 x 3 sites, about
// even with cuBLAS at the dense and 1 x 1 ones, where K is 3-10 steps and a
// block's fixed cost (launch, first load, epilogue) is most of the call.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_s8.cuh"

// Q2 (quant_act.cu, linked into the same library)
extern "C" int quant_act_s8(const void* x, int dtype, int64_t rows, int C, int Cp, void* x8,
                            void* barrier, void* stats, int is_static, float static_amax,
                            void* stream);

namespace {

constexpr int BM = 128;                // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 128;                // bytes (int8 values) of K a stage: one swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 256;        // warpgroups 0 and 1
constexpr int kThreads = 384;          // and the producer, warpgroup 2
constexpr int kFullArrivals = 128 + 1; // the producer's cp.async arrivals + the TMA's expect_tx
constexpr int kEmptyArrivals = 8;      // one per consumer warp
constexpr uint32_t kMaxSplits = 8;     // a tile's splits are one cluster: 8 is the portable most

struct Geometry {
  int B, H, W, Cp, O, KH, KW, stride, pad, Ho, Wo, M, K;
  int a_by_tma;  // a 1 x 1, stride 1, unpadded product: the activation is a [M, K] matrix
};

template <int BN>
constexpr int smem_bytes() {  // 1024: alignment slack; the ring, its barriers, then per column
  return 1024 + kStages * (BM * BK + BN * BK) + 2 * kStages * 8 + 2 * BN * 4;
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the barrier has completed the phase of the given parity. A wait
// that never ends would hang the card, so it gives up after a bounded number
// of tries and aborts the kernel; the launch then reports an error.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int tries = 0; tries < (1 << 22); ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// the box at (c0 along K, c1 along O) of the weight's tensor map
__device__ inline void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                   int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes global -> shared, asynchronous; zeros when !ok
__device__ inline void cp_async_16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// arrive on the barrier once this thread's cp.async copies so far have landed
__device__ inline void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// K-major operand with the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused by this layout
__device__ inline uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// every thread of every block of the cluster; orders shared-memory writes
// before the barrier with reads after it, across the cluster
__device__ inline void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// 16 bytes of block `rank`'s shared memory, at the address `addr` has in ours
__device__ inline int4 ld_cluster_16(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote));
  return v;
}

__device__ inline void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_float(int x) { return static_cast<float>(x); }  // no bias in int32 mode
template <typename T>
__device__ inline T round_to(float x);
template <>
__device__ inline float round_to<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 round_to<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// the epilogue of one sum: scale = wscale[n] * xscale and bias as float, both
// read from shared memory
template <typename T>
__device__ inline T rescale(int acc, float scale, float bias, bool has_bias) {
  T v = round_to<T>(__fmul_rn(__int2float_rn(acc), scale));
  if (has_bias) v = round_to<T>(__fadd_rn(to_float(v), bias));
  return v;
}
// int32 mode: the sum itself
template <>
__device__ inline int rescale<int>(int acc, float, float, bool) { return acc; }

__device__ inline void store_pair(uint8_t* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ inline void store_pair(uint8_t* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}
__device__ inline void store_pair(uint8_t* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap amap, const int8_t* __restrict__ x8,
                       const float* __restrict__ wscale, const float* __restrict__ stats,
                       const T* __restrict__ bias, T* __restrict__ out, Geometry g,
                       int kb_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = smem;                          // kStages x [BM rows x 128 bytes], swizzled
  uint8_t* b_ring = smem + kStages * BM * BK;      // kStages x [BN rows x 128 bytes], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + kStages * BN * BK);
  uint64_t* empty = full + kStages;
  float* col_scale = reinterpret_cast<float*>(empty + kStages);  // [BN] wscale[n] * xscale
  float* col_bias = col_scale + BN;                              // [BN] float(bias[n])

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kblocks = (g.K + BK - 1) / BK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nk = min(kblocks, kb0 + kb_per_split) - kb0;  // >= 1: the caller's schedule

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), g.a_by_tma ? 1 : kFullArrivals);
      mbar_init(smem_u32(&empty[s]), kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: warpgroup 2 ----
    const int p = tid - kConsumers;
    if (g.a_by_tma) {  // both tiles by TMA, from the producer's first thread
      for (int it = 0; it < nk && p == 0; ++it) {
        const int s = it % kStages;
        const uint32_t full_s = smem_u32(&full[s]);
        mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_s, (BM + BN) * BK);
        tma_load_2d(smem_u32(a_ring + s * BM * BK), &amap, full_s, (kb0 + it) * BK, m0);
        tma_load_2d(smem_u32(b_ring + s * BN * BK), &wmap, full_s, (kb0 + it) * BK, n0);
      }
    } else {
      if (p == 0) asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                               : "memory");
      const int piece = p & 7;          // which 16 bytes of the 128-byte K step
      const int r0 = p >> 3;            // rows r0 + 16 i of the tile
      const uint32_t swz = static_cast<uint32_t>(r0 * BK + ((piece ^ (r0 & 7)) << 4));
      int pix[8], yx[8];                // each row's top-left input pixel, and (iy0, ix0) packed
      const int hw = g.Ho * g.Wo;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + r0 + 16 * i;
        int iy = -30000, ix = 0;        // a row past M: never inside the image
        pix[i] = 0;
        if (m < g.M) {
          const int b = m / hw;
          const int rem = m - b * hw;
          const int oy = rem / g.Wo;
          iy = oy * g.stride - g.pad;
          ix = (rem - oy * g.Wo) * g.stride - g.pad;
          pix[i] = (b * g.H + iy) * g.W + ix;
        }
        yx[i] = (iy << 16) | (ix & 0xffff);
      }
      // the tap (ky, kx) and channel c of this thread's piece at the first step
      const int k = kb0 * BK + piece * 16;
      const int tap = k / g.Cp;
      int c = k - tap * g.Cp;
      int ky = tap / g.KW;
      int kx = tap - ky * g.KW;
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        const uint32_t full_s = smem_u32(&full[s]);
        mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);
        if (p == 0) {
          mbar_expect_tx(full_s, BN * BK);
          tma_load_2d(smem_u32(b_ring + s * BN * BK), &wmap, full_s, (kb0 + it) * BK, n0);
        }
        const uint32_t a_dst = smem_u32(a_ring + s * BM * BK) + swz;
        const bool k_ok = ky < g.KH;
        const int tap_off = ky * g.W + kx;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int iy = (yx[i] >> 16) + ky;
          const int ix = static_cast<int>(static_cast<int16_t>(yx[i] & 0xffff)) + kx;
          const bool ok = k_ok && static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                          static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
          const int8_t* src =
              ok ? x8 + static_cast<int64_t>(pix[i] + tap_off) * g.Cp + c : x8;
          cp_async_16(a_dst + i * 16 * BK, src, ok);
        }
        cp_async_arrive(full_s);
        c += BK;
        while (c >= g.Cp) {
          c -= g.Cp;
          if (++kx == g.KW) {
            kx = 0;
            ++ky;
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    if (gridDim.z == 1) return;
  } else {
    // ---- consumers: warpgroups 0 and 1, 64 rows each ----
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    if (tid < BN) {  // the epilogue's factors of each column, read before the epilogue's barrier
      const int n = n0 + tid;
      col_scale[tid] = n < g.O && wscale != nullptr ? __fmul_rn(wscale[n], stats[1]) : 0.f;
      col_bias[tid] = n < g.O && bias != nullptr ? to_float(bias[n]) : 0.f;
    }
    int acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
      // the producer's cp.async writes are generic-proxy writes; wgmma reads
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint64_t da = sw128_desc(smem_u32(a_ring + s * BM * BK + wg * 64 * BK));
      const uint64_t db = sw128_desc(smem_u32(b_ring + s * BN * BK));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous step's products are done: its stage goes back to the
      // producer while this step's run
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % kStages]));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    const int row = 16 * warp + (lane >> 2);  // of the warpgroup's 64; +8 for e >= 2
    const int col = 2 * (lane & 3);           // of the tile's BN; +8j, +1 for odd e
    const int mbase = m0 + wg * 64;
    if (gridDim.z == 1) {
      // both warpgroups are past their last wgmma and the producer's copies
      // have all landed: the ring is free for the output tile
      named_sync(1, kConsumers);
      constexpr int kPitch = BN * static_cast<int>(sizeof(T)) + 16;
      uint8_t* tile = smem + wg * 64 * kPitch;
      const bool has_bias = bias != nullptr;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cc = 8 * j + col;
        const float2 sc = *reinterpret_cast<const float2*>(col_scale + cc);
        const float2 bi = *reinterpret_cast<const float2*>(col_bias + cc);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(tile + (row + 8 * h) * kPitch + cc * static_cast<int>(sizeof(T)),
                     rescale<T>(acc[4 * j + 2 * h], sc.x, bi.x, has_bias),
                     rescale<T>(acc[4 * j + 2 * h + 1], sc.y, bi.y, has_bias));
      }
      named_sync(2 + wg, 128);
      constexpr int kVec = 16 / static_cast<int>(sizeof(T));
      constexpr int kChunks = BN / kVec;
      const bool vec_ok = g.O % kVec == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
      for (int i = tid & 127; i < 64 * kChunks; i += 128) {
        const int r = i / kChunks, ch = i - r * kChunks;
        const int m = mbase + r, n = n0 + ch * kVec;
        if (m >= g.M || n >= g.O) continue;
        const uint8_t* src = tile + r * kPitch + ch * 16;
        T* dst = out + static_cast<int64_t>(m) * g.O + n;
        if (vec_ok && n + kVec <= g.O) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < kVec && n + e < g.O; ++e) dst[e] = reinterpret_cast<const T*>(src)[e];
        }
      }
      return;
    }
    // a split of K: this block's int32 sums, staged as a dense [BM, BN] tile
    named_sync(1, kConsumers);  // both warpgroups are past their last wgmma
    int* part = reinterpret_cast<int*>(smem);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(part + (wg * 64 + row + 8 * h) * BN + 8 * j + col) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }

  // The splits of a tile are one cluster along z (at most 8 blocks). Each
  // block sums every split's tile, through distributed shared memory, over
  // its own slice of the rows, and writes that slice's output, 8 columns a
  // thread and 16-byte stores; all 384 threads take part.
  cluster_sync();
  const uint32_t splits = gridDim.z, rank = blockIdx.z;
  const int rows_per = (BM + splits - 1) / splits;
  const int r_begin = rank * rows_per, r_end = min(BM, r_begin + rows_per);
  const uint32_t part_addr = smem_u32(smem);
  const bool has_bias = bias != nullptr;
  const bool vec_ok = g.O % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = r_begin * (BN / 8) + tid; i < r_end * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m >= g.M || n >= g.O) continue;
    const uint32_t at = part_addr + static_cast<uint32_t>((r * BN + c8) * 4);
    int4 lo[kMaxSplits], hi[kMaxSplits];
#pragma unroll
    for (uint32_t q = 0; q < kMaxSplits; ++q)  // every split's loads in flight, then the sums
      if (q < splits) lo[q] = ld_cluster_16(at, q), hi[q] = ld_cluster_16(at + 16, q);
    int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (uint32_t q = 0; q < kMaxSplits; ++q)
      if (q < splits) {
        sum[0] += lo[q].x, sum[1] += lo[q].y, sum[2] += lo[q].z, sum[3] += lo[q].w;
        sum[4] += hi[q].x, sum[5] += hi[q].y, sum[6] += hi[q].z, sum[7] += hi[q].w;
      }
    T v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = rescale<T>(sum[e], col_scale[c8 + e], col_bias[c8 + e], has_bias);
    T* dst = out + static_cast<int64_t>(m) * g.O + n;
    if (vec_ok && n + 8 <= g.O) {
#pragma unroll
      for (int q = 0; q < 8 * static_cast<int>(sizeof(T)) / 16; ++q)
        reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(v)[q];
    } else {
      for (int e = 0; e < 8 && n + e < g.O; ++e) dst[e] = v[e];
    }
  }
  cluster_sync();  // no block leaves while the others read its tile
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

constexpr int kMaxDevices = 64;

template <typename T, int BN>
int launch_bn(const int8_t* x8, const int8_t* w8, const float* wscale, const float* stats,
              const T* bias, T* out, int splits, int kb_per, const Geometry& g,
              cudaStream_t stream) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.K), static_cast<cuuint64_t>(g.O)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.K)};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w8), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -2;
  CUtensorMap amap = {};
  if (g.a_by_tma) {  // x8 as [M, K]: the same box shape and swizzle as the weight's
    const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(g.K), static_cast<cuuint64_t>(g.M)};
    const cuuint32_t a_box[2] = {BK, BM};
    if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(x8), a_dims, strides,
               a_box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -2;
  }
  constexpr int smem = smem_bytes<BN>();
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return -1;
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_wgmma_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // a tile's splits: one cluster
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.M + BM - 1) / BM, (g.O + BN - 1) / BN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, int8_conv_wgmma_kernel<T, BN>, map, amap, x8, wscale, stats, bias,
                         out, g, kb_per);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(const int8_t* x8, const int8_t* w8, const float* wscale, const float* stats,
           const T* bias, T* out, int bn, int splits, int kb_per, const Geometry& g,
           cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch_bn<T, 32>(x8, w8, wscale, stats, bias, out, splits, kb_per, g, stream);
    case 160:
      return launch_bn<T, 160>(x8, w8, wscale, stats, bias, out, splits, kb_per, g, stream);
    case 256:
      return launch_bn<T, 256>(x8, w8, wscale, stats, bias, out, splits, kb_per, g, stream);
    default:
      return -1;
  }
}

}  // namespace

// x8 [B, H, W, Cp], w8 [O, KH, KW, Cp] int8 (16-byte aligned, Cp % 16 == 0);
// stats [2] float32 (xscale at [1]); wscale [O] float32; bias [O] in the output
// type when has_bias; out [B, Ho, Wo, O] float32 (out_dtype 0) or bfloat16 (1),
// or int32 (2): the accumulators, with no bias, wscale and stats unread.
// The tile width bn (32, 160 or 256), the splits of K (at most 8: one cluster)
// and the 128-byte K steps of a split (kb_per) are
// ops/quant.py::conv_schedule's: every split holds at least one step. Returns
// 0, -1 for arguments the kernel does not take, -2 when the weight's tensor
// map cannot be made, or the CUDA error of the launch.
extern "C" int int8_conv_s8(const void* x8, const void* stats, const void* w8,
                            const void* wscale, const void* bias, int has_bias, void* out,
                            int out_dtype, int bn, int splits, int kb_per, int B, int H, int W,
                            int Cp, int O, int KH, int KW, int stride, int pad, int Ho, int Wo,
                            void* stream) {
  if (B < 1 || H < 1 || W < 1 || O < 1 || KH < 1 || KW < 1 || stride < 1 || pad < 0) return -1;
  if (H >= 16384 || W >= 16384 || pad >= 16384) return -1;
  if (Cp < 16 || Cp % 16 || splits < 1 || splits > static_cast<int>(kMaxSplits) || kb_per < 1)
    return -1;
  if (Ho != (H + 2 * pad - KH) / stride + 1 || Wo != (W + 2 * pad - KW) / stride + 1) return -1;
  if (Ho < 1 || Wo < 1 || (has_bias && bias == nullptr)) return -1;
  if (reinterpret_cast<uintptr_t>(x8) % 16 || reinterpret_cast<uintptr_t>(w8) % 16) return -1;
  const int64_t m = static_cast<int64_t>(B) * Ho * Wo;
  const int64_t k = static_cast<int64_t>(KH) * KW * Cp;
  const int64_t kblocks = (k + BK - 1) / BK;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL || static_cast<int64_t>(B) * H * W > 0x7fffffffLL)
    return -1;
  if (bn < 1 || (O + bn - 1) / bn > 65535) return -1;
  if (static_cast<int64_t>(splits - 1) * kb_per >= kblocks ||
      static_cast<int64_t>(splits) * kb_per < kblocks)
    return -1;  // an empty split, or steps no split holds
  const Geometry g{B, H, W, Cp, O, KH, KW, stride, pad, Ho, Wo, static_cast<int>(m),
                   static_cast<int>(k), KH == 1 && KW == 1 && stride == 1 && pad == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(x8);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* ws = static_cast<const float*>(wscale);
  const float* st = static_cast<const float*>(stats);
  if (out_dtype == 0)
    return launch(x, w, ws, st, has_bias ? static_cast<const float*>(bias) : nullptr,
                  static_cast<float*>(out), bn, splits, kb_per, g, s);
  if (out_dtype == 1)
    return launch(x, w, ws, st, has_bias ? static_cast<const __nv_bfloat16*>(bias) : nullptr,
                  static_cast<__nv_bfloat16*>(out), bn, splits, kb_per, g, s);
  if (out_dtype == 2 && !has_bias)
    return launch<int>(x, w, nullptr, nullptr, nullptr, static_cast<int*>(out), bn, splits,
                       kb_per, g, s);
  return -1;
}

// A whole quantized site in one call, two launches: Q2 quantizes the
// activation x [B*H*W, C] (float32 dtype 0, bfloat16 1) into x8 [B*H*W, Cp]
// and stats (quant_act_s8's arguments), then Q1 reads them (int8_conv_s8's
// arguments after x8 and stats; its output type is x's). Nothing is launched
// when Q1 does not take its arguments.
extern "C" int w8a8_site_s8(const void* x, int dtype, int C, void* x8, void* barrier,
                            void* stats, int is_static, float static_amax,
                            const void* w8, const void* wscale, const void* bias, int has_bias,
                            void* out, int out_dtype, int bn, int splits, int kb_per, int B,
                            int H, int W, int Cp, int O, int KH, int KW, int stride, int pad,
                            int Ho, int Wo, void* stream) {
  if (out_dtype != dtype || C < 1 || C > Cp) return -1;
  const int err = quant_act_s8(x, dtype, static_cast<int64_t>(B) * H * W, C, Cp, x8, barrier,
                               stats, is_static, static_amax, stream);
  if (err != 0) return err;
  return int8_conv_s8(x8, stats, w8, wscale, bias, has_bias, out, out_dtype, bn, splits, kb_per,
                      B, H, W, Cp, O, KH, KW, stride, pad, Ho, Wo, stream);
}
