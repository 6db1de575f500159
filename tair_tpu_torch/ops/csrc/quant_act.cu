// Per-tensor symmetric int8 quantize of an activation (Q2 of the w8a8 serving
// path) for Hopper (sm_90a), plain C interface.
//
// No Pallas kernel stands behind it: it is tair_tpu/ops/quant.py::_quant_act,
// which XLA fuses in front of the s8 x s8 -> s32 product there. Function, for
// x [rows, C] (float32 or bfloat16, contiguous):
//   amax     = max |x|                    (dynamic; NaN if x holds one), the
//                                          caller's amax (static), or the amax
//                                          that stats[0] holds on the device
//                                          (device amax)
//   scale    = amax <= 0 ? 1 : amax / 127 (IEEE division, as the JAX package;
//                                          a NaN amax gives a NaN scale)
//   x8[r, c] = rint(x[r, c] / scale)      (half to even; clipped to +-127 on the
//                                          static and device-amax paths) for c < C,
//                                          0 for C <= c < Cp
//   stats    = (amax, scale)
// and a fourth mode, amax only: stats = (max |x|, 0), no x8. The last two serve
// a row-parallel site under tensor parallelism (parallel/tp.py): its amax-only
// pass gives this process's abs-max, which the caller all-reduces (MAX over
// the model axis, on the device) into stats[0] before the device-amax pass
// quantizes with the axis' scale; at equal amax the device-amax path gives
// the dynamic path's bits.
// x8 is [rows, Cp] with Cp a multiple of 16: channels innermost, padded, the
// layout the int8 convolution (int8_conv.cu) reads in 16-byte pieces.
//
// Bound on this card: bytes (x read, x8 written). Design: one launch on both
// paths. Dynamic: a cooperative launch of at most two blocks an SM (all
// resident at once, or the launch fails), each folding a grid-stride share of
// x, 8 channels of a row at a time in 16-byte loads (four groups in flight a
// thread, held in registers for pass 2: at a step's sizes both passes are
// bound by latency), into one maximum; then one grid-wide fold and barrier
// (grid_scale: an atomicMax on the maximum's bits, an arrival counter, and a
// 64-bit word that publishes the generation and the scale together, all in
// device scratch and left ready for the next call), so the scale never leaves
// the device and the host never waits; then each thread writes 8 int8 values
// at a time as one 8-byte store, reading x a second time (from L2) only for
// groups beyond the four it holds. Static and device amax: the quantize pass
// alone. Amax only: the first pass alone, each block folding into one
// atomicMax on the bits of stats[0] (zeroed before the launch). The division stays a division (no reciprocal), so the kernel equals
// its plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_load.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;       // of the dynamic path's resident grid
constexpr int kUnroll = 4;            // groups of 8 a thread loads at once, held across the barrier
constexpr int kMaxDevices = 64;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// max that keeps a NaN (fmaxf drops it), as the plain version's amax() does
__device__ inline float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ inline float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ inline unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ inline unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ inline void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// The grid-wide fold and barrier of the dynamic path, by every block's thread
// 0 (the grid is resident: cooperative launch); returns the scale. barrier[0]
// counts arrivals, barrier[1] holds the running max's bits (|x| >= 0 or a NaN
// with its sign cleared: such floats order as their bits do, a NaN above
// everything, so atomicMax keeps a NaN), barrier[2..3] the published
// (generation, scale). The last block to arrive computes the scale, writes
// stats, leaves the words ready for the next call and publishes; the others
// wait for the generation to move. A wait that never ends would hang the
// card, so it gives up after a bounded number of tries and aborts the kernel.
__device__ inline float grid_scale(unsigned* barrier, float block_max, float* stats) {
  unsigned long long* published = reinterpret_cast<unsigned long long*>(barrier + 2);
  const unsigned long long seen = ld_acquire(published);  // cannot move before we arrive
  atomicMax(barrier + 1, __float_as_uint(block_max));
  if (atom_add_acq_rel(barrier, 1u) == gridDim.x - 1) {
    const float amax = __uint_as_float(__ldcg(barrier + 1));
    const float scale = amax <= 0.f ? 1.f : __fdiv_rn(amax, 127.f);
    stats[0] = amax;
    stats[1] = scale;
    barrier[1] = 0u;
    barrier[0] = 0u;
    st_release(published, (static_cast<unsigned long long>(__float_as_uint(scale)) << 32) |
                              static_cast<unsigned>(seen + 1));
    return scale;
  }
  for (int tries = 0; tries < (1 << 26); ++tries) {
    const unsigned long long now = ld_acquire(published);
    if (static_cast<unsigned>(now) != static_cast<unsigned>(seen))
      return __uint_as_float(static_cast<unsigned>(now >> 32));
  }
  __trap();
  return 0.f;
}

template <typename T>
__device__ inline void load8(const T* p, bool vec, int valid, float (&v)[8]) {
  if (vec && valid >= 8) {
    constexpr int N = VecLoad<T>::N;
#pragma unroll
    for (int j = 0; j < 8; j += N) VecLoad<T>::load(p + j, v + j);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? to_float(p[e]) : 0.f;
  }
}

// the modes of quant_act_s8's is_static argument
constexpr int kDynamic = 0, kStaticAmax = 1, kDeviceAmax = 2, kAmaxOnly = 3;

template <typename T>
__global__ void __launch_bounds__(kThreads)
act_amax_kernel(const T* __restrict__ x, int64_t rows, int C, int Cp, int vec_rows,
                unsigned* __restrict__ amax_bits) {
  __shared__ float warp_maxima[kThreads / 32];
  const int groups = Cp / 8;
  const int total = static_cast<int>(rows) * groups;
  float m = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    const int r = i / groups;
    const int c0 = (i - r * groups) * 8;
    float v[8];
    load8(x + static_cast<int64_t>(r) * C + c0, vec_rows, C - c0, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = max_nan(m, fabsf(v[e]));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) warp_maxima[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, warp_maxima[w]);
    atomicMax(amax_bits, __float_as_uint(m));  // |x| or a NaN with its sign cleared: bits order
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
quant_act_kernel(const T* __restrict__ x, int64_t rows, int C, int Cp, int vec_rows,
                 unsigned* __restrict__ barrier, float static_amax, int8_t* __restrict__ x8,
                 float* __restrict__ stats) {
  __shared__ float s_scale;
  __shared__ float warp_maxima[kThreads / 32];
  const int gtid = blockIdx.x * kThreads + threadIdx.x;  // rows * Cp < 2^31: int indices
  constexpr bool kStatic = kMode != kDynamic;  // the clip of the given amax's paths
  const int nth = gridDim.x * kThreads;
  const int groups = Cp / 8;
  const int total = static_cast<int>(rows) * groups;
  // group i: channels 8 (i % groups) .. + 8 of row i / groups, zeros past C
  auto load_group = [&](int i, float (&v)[8]) {
    const int r = i / groups;
    const int c0 = (i - r * groups) * 8;
    load8(x + static_cast<int64_t>(r) * C + c0, vec_rows, C - c0, v);
  };
  auto store_group = [&](int i, const float (&v)[8], float scale) {
    const int r = i / groups;
    const int c0 = (i - r * groups) * 8;
    union {
      int8_t b[8];
      uint2 u;
    } q;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float t = rintf(__fdiv_rn(v[e], scale));
      if (kStatic) t = fminf(fmaxf(t, -127.f), 127.f);
      q.b[e] = static_cast<int8_t>(static_cast<int>(t));
    }
    *reinterpret_cast<uint2*>(x8 + static_cast<int64_t>(r) * Cp + c0) = q.u;
  };
  // the dynamic path's first kUnroll groups of this thread: loaded together in
  // pass 1 and held in registers across the barrier, so pass 2 does not read
  // them again
  float kept[kUnroll][8];
  if (!kStatic) {
    float m = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = gtid + u * nth;
      if (i < total) {
        load_group(i, kept[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kept[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) m = max_nan(m, fabsf(kept[u][e]));
    for (int i = gtid + kUnroll * nth; i < total; i += nth) {  // beyond what registers hold
      float v[8];
      load_group(i, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = max_nan(m, fabsf(v[e]));
    }
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) warp_maxima[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, warp_maxima[w]);
      s_scale = grid_scale(barrier, m, stats);
    }
  } else if (threadIdx.x == 0) {
    // device amax: stats[0] as the caller left it (read by every block, never written)
    const float amax = kMode == kDeviceAmax ? stats[0] : static_amax;
    const float scale = amax <= 0.f ? 1.f : __fdiv_rn(amax, 127.f);
    s_scale = scale;
    if (blockIdx.x == 0) {
      if (kMode != kDeviceAmax) stats[0] = amax;
      stats[1] = scale;
    }
  }
  __syncthreads();
  // pass 2: 8 channels of one row a thread, one 8-byte store
  const float scale = s_scale;
  int first = gtid;
  if (!kStatic) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = gtid + u * nth;
      if (i < total) store_group(i, kept[u], scale);
    }
    first = gtid + kUnroll * nth;
  }
  for (int i = first; i < total; i += nth) {
    float v[8];
    load_group(i, v);
    store_group(i, v, scale);
  }
}

// blocks of the dynamic path's grid that the card holds at once
template <typename T>
int resident_blocks() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quant_act_kernel<T, kDynamic>,
                                                      kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  return cached[dev];
}

template <typename T>
int launch(const T* x, int64_t rows, int C, int Cp, int8_t* x8, unsigned* barrier,
           float* stats, int mode, float static_amax, cudaStream_t stream) {
  // 16-byte loads need every row of x on a 16-byte boundary
  const int per16 = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_rows = aligned && C % per16 == 0;
  const int64_t want = rows * (Cp / 8) / kThreads + 1;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (mode == kAmaxOnly) {
    const cudaError_t err = cudaMemsetAsync(stats, 0, 2 * sizeof(float), stream);
    if (err != cudaSuccess) return err;
    act_amax_kernel<T><<<blocks, kThreads, 0, stream>>>(x, rows, C, Cp, vec_rows,
                                                        reinterpret_cast<unsigned*>(stats));
    return cudaGetLastError();
  }
  if (mode == kStaticAmax) {
    quant_act_kernel<T, kStaticAmax><<<blocks, kThreads, 0, stream>>>(
        x, rows, C, Cp, vec_rows, nullptr, static_amax, x8, stats);
    return cudaGetLastError();
  }
  if (mode == kDeviceAmax) {
    quant_act_kernel<T, kDeviceAmax><<<blocks, kThreads, 0, stream>>>(
        x, rows, C, Cp, vec_rows, nullptr, 0.f, x8, stats);
    return cudaGetLastError();
  }
  const int resident = resident_blocks<T>();
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(want < resident ? want : resident);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, quant_act_kernel<T, kDynamic>, x, rows, C, Cp,
                                             vec_rows, barrier, 0.f, x8, stats);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x: [rows, C] float32 (dtype 0) or bfloat16 (dtype 1), contiguous; x8: [rows,
// Cp] int8, 8-byte aligned, rows * Cp < 2^31 (unused by the amax-only mode);
// stats: 2 floats out (the device-amax mode reads the amax at [0] and writes
// the scale at [1]). is_static: 0 dynamic, 1 static (static_amax), 2 device
// amax, 3 amax only. The dynamic path's scratch:
// barrier, 4 uint32 (8-byte aligned) that hold zeros before the first call
// and are left ready for the next (one scratch per stream: two launches must
// not share it at once). Returns 0, -1 for arguments the kernel does not
// take, or the CUDA error of the launch.
extern "C" int quant_act_s8(const void* x, int dtype, int64_t rows, int C, int Cp, void* x8,
                            void* barrier, void* stats, int is_static, float static_amax,
                            void* stream) {
  if (is_static < kDynamic || is_static > kAmaxOnly) return -1;
  if (rows < 1 || C < 1 || Cp < C || Cp % 16) return -1;
  if (is_static != kAmaxOnly && (x8 == nullptr || reinterpret_cast<uintptr_t>(x8) % 8)) return -1;
  if (rows * Cp > 0x7fffffffLL) return -1;  // int indices
  if (is_static == kDynamic &&
      (barrier == nullptr || reinterpret_cast<uintptr_t>(barrier) % 8)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(x8);
  unsigned* b = static_cast<unsigned*>(barrier);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return launch(static_cast<const float*>(x), rows, C, Cp, q, b, st, is_static, static_amax,
                  s);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), rows, C, Cp, q, b, st, is_static,
                  static_amax, s);
  return -1;
}
