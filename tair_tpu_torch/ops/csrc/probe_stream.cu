// Probe of streaming a large bfloat16 matrix out of device memory once, on
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU probe scripts/stream_probe.py: _autocopy_kernel (blocks
// pipelined by the compiler) and _manual_kernel (a hand-written ring of
// asynchronous copies). Both read g [R, 128] bfloat16 once; here both produce
// its 128 column sums in float32, so that what was read can be checked:
//   out[c] = sum_r g[r, c]
//
// Bound on this card: bytes (g read once; one add per value).
//
// Two kernels, to tell how much of the memory rate a plain loop of wide loads
// reaches and whether a deeper ring of asynchronous copies reaches more:
//   strided   a grid-stride loop; a thread owns one 16-byte column piece (8
//             columns) and walks down the rows with UNROLL loads in flight,
//             adding into 8 float registers;
//   pipeline  persistent blocks, each walking over chunks of rows; a chunk is
//             copied into one of STAGES shared-memory buffers with cp.async
//             (16 bytes a copy, no registers in between), STAGES - 1 chunks
//             stay in flight while the oldest is summed. A thread sums the
//             pieces it copied itself, so the ring needs no block barrier;
//   bulk      the same ring filled by the copy engine: one thread asks for a
//             whole chunk with cp.async.bulk, which reports the bytes that
//             landed to an mbarrier in shared memory; every thread waits on
//             that barrier, sums its pieces, and a block barrier frees the
//             buffer for the next request.
// Every block writes its 128 partial sums; a second small kernel adds the
// blocks' partials in a fixed order, so a result does not change between runs.
// Both kernels' time is the probe's time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
constexpr int kPiecesPerRow = kCols / 8;  // 16-byte pieces in a row
constexpr int kMaxThreads = 512;

__device__ inline void add_piece(float* acc, const uint4& raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

// Sum the block's per-thread accumulators column by column, in thread order,
// and write the block's 128 partial sums.
__device__ inline void block_partials(const float* acc, float* __restrict__ partials) {
  __shared__ float red[kMaxThreads][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) red[threadIdx.x][i] = acc[i];
  __syncthreads();
  if (threadIdx.x < kCols) {
    const int piece = threadIdx.x / 8, e = threadIdx.x % 8;
    float s = 0.f;
    for (int t = piece; t < blockDim.x; t += kPiecesPerRow) s += red[t][e];
    partials[static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x] = s;
  }
}

// blockDim.x is a multiple of 16, so a thread keeps its column piece.
template <int UNROLL>
__global__ void __launch_bounds__(kMaxThreads)
stream_strided_kernel(const uint4* __restrict__ g, float* __restrict__ partials,
                      int64_t n_pieces) {
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; p + (UNROLL - 1) * stride < n_pieces; p += UNROLL * stride) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = g[p + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_piece(acc, raw[u]);
  }
  for (; p < n_pieces; p += stride) add_piece(acc, g[p]);
  block_partials(acc, partials);
}

__device__ inline void cp_async_16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// chunk_pieces = 16-byte pieces in one chunk, a multiple of blockDim.x.
template <int STAGES>
__global__ void __launch_bounds__(kMaxThreads)
stream_pipeline_kernel(const uint4* __restrict__ g, float* __restrict__ partials,
                       int64_t n_chunks, int chunk_pieces) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  uint4* ring = reinterpret_cast<uint4*>(ring_bytes);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const int per_thread = chunk_pieces / blockDim.x;

  auto copy_chunk = [&](int64_t chunk, int stage) {
    if (chunk < n_chunks) {
      const uint4* src = g + chunk * chunk_pieces;
      uint4* dst = ring + static_cast<int64_t>(stage) * chunk_pieces;
      for (int k = 0; k < per_thread; ++k) {
        const int at = threadIdx.x + k * blockDim.x;
        cp_async_16(dst + at, src + at);
      }
    }
    cp_async_commit();  // an empty group keeps the count of groups in step
  };

  int64_t next = blockIdx.x;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s, next += gridDim.x) copy_chunk(next, s);
  int stage = 0;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    copy_chunk(next, (stage + STAGES - 1) % STAGES);
    next += gridDim.x;
    cp_async_wait<STAGES - 1>();  // the oldest group, this chunk, has landed
    const uint4* buf = ring + static_cast<int64_t>(stage) * chunk_pieces;
    for (int k = 0; k < per_thread; ++k)
      add_piece(acc, buf[threadIdx.x + k * blockDim.x]);
    stage = (stage + 1) % STAGES;
  }
  cp_async_wait<0>();
  block_partials(acc, partials);
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Wait until the barrier has completed the phase of the given parity. A wait
// that never ends would hang the card, so it gives up after a bounded number
// of tries and aborts the kernel; the launch then reports an error.
__device__ inline void mbarrier_wait(unsigned bar, unsigned parity) {
  for (int tries = 0; tries < (1 << 22); ++tries) {
    unsigned done;
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

// chunk_pieces = 16-byte pieces in one chunk, a multiple of blockDim.x.
template <int STAGES>
__global__ void __launch_bounds__(kMaxThreads)
stream_bulk_kernel(const uint4* __restrict__ g, float* __restrict__ partials,
                   int64_t n_chunks, int chunk_pieces) {
  extern __shared__ __align__(128) unsigned char bulk_ring_bytes[];
  __shared__ __align__(8) unsigned long long full[STAGES];
  uint4* ring = reinterpret_cast<uint4*>(bulk_ring_bytes);
  const unsigned chunk_bytes = static_cast<unsigned>(chunk_pieces) * 16u;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const int per_thread = chunk_pieces / blockDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 only: ask for `chunk` to be copied into buffer `stage`
  auto request = [&](int64_t chunk, int stage) {
    if (chunk >= n_chunks) return;
    const unsigned bar = smem_addr(&full[stage]);
    const unsigned dst = smem_addr(ring + static_cast<int64_t>(stage) * chunk_pieces);
    const uint4* src = g + chunk * chunk_pieces;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(chunk_bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(chunk_bytes), "r"(bar)
        : "memory");
  };

  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES; ++s)
      request(blockIdx.x + static_cast<int64_t>(s) * gridDim.x, s);

  int64_t it = 0;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x, ++it) {
    const int stage = static_cast<int>(it % STAGES);
    mbarrier_wait(smem_addr(&full[stage]), static_cast<unsigned>((it / STAGES) & 1));
    const uint4* buf = ring + static_cast<int64_t>(stage) * chunk_pieces;
    for (int k = 0; k < per_thread; ++k)
      add_piece(acc, buf[threadIdx.x + k * blockDim.x]);
    __syncthreads();  // every thread has read the buffer: it may be filled again
    if (threadIdx.x == 0) request(chunk + static_cast<int64_t>(STAGES) * gridDim.x, stage);
  }
  block_partials(acc, partials);
}

// One block per 8 columns; 32 threads share a column, each adding every 32nd
// block's partial, and the 32 sums are then added in thread order. The order
// is fixed, and no thread walks over more than n_blocks / 32 partials, so the
// pass stays small beside the streaming kernel it follows.
constexpr int kFinishParts = 32;
__global__ void __launch_bounds__(8 * kFinishParts)
finish_kernel(const float* __restrict__ partials, float* __restrict__ out,
              int n_blocks) {
  __shared__ float red[kFinishParts][8];
  const int c = threadIdx.x % 8, part = threadIdx.x / 8;
  const int col = blockIdx.x * 8 + c;
  float s = 0.f;
  for (int b = part; b < n_blocks; b += kFinishParts) s += partials[b * kCols + col];
  red[part][c] = s;
  __syncthreads();
  if (part == 0) {
    float total = 0.f;
    for (int i = 0; i < kFinishParts; ++i) total += red[i][c];
    out[col] = total;
  }
}

bool threads_ok(int threads) {
  return threads >= kCols && threads <= kMaxThreads && threads % kPiecesPerRow == 0;
}

}  // namespace

// g [R, 128] bfloat16 contiguous, aligned to 16 bytes; partials [blocks, 128]
// float scratch; out [128] float. Returns the CUDA error code, -1 for a setting
// that has no kernel.
extern "C" int probe_stream_strided(const void* g, float* partials, float* out,
                                    int64_t rows, int threads, int unroll,
                                    int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!threads_ok(threads) || blocks < 1) return -1;
  const int64_t n_pieces = rows * kPiecesPerRow;
  const uint4* gp = static_cast<const uint4*>(g);
  switch (unroll) {
    case 1: stream_strided_kernel<1><<<blocks, threads, 0, s>>>(gp, partials, n_pieces); break;
    case 2: stream_strided_kernel<2><<<blocks, threads, 0, s>>>(gp, partials, n_pieces); break;
    case 4: stream_strided_kernel<4><<<blocks, threads, 0, s>>>(gp, partials, n_pieces); break;
    case 8: stream_strided_kernel<8><<<blocks, threads, 0, s>>>(gp, partials, n_pieces); break;
    default: return -1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<kCols / 8, 8 * kFinishParts, 0, s>>>(partials, out, blocks);
  return cudaGetLastError();
}

// As above; chunk_rows rows make one chunk (rows must be a multiple of it, and
// a chunk's pieces a multiple of the block's threads).
extern "C" int probe_stream_pipeline(const void* g, float* partials, float* out,
                                     int64_t rows, int threads, int stages,
                                     int chunk_rows, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!threads_ok(threads) || blocks < 1 || chunk_rows < 1) return -1;
  const int chunk_pieces = chunk_rows * kPiecesPerRow;
  if (rows % chunk_rows || chunk_pieces % threads) return -1;
  const int64_t n_chunks = rows / chunk_rows;
  const int smem = stages * chunk_pieces * 16;
  if (smem > 200 * 1024) return -1;  // the ring beside 16 KB for the partials
  const uint4* gp = static_cast<const uint4*>(g);
  cudaError_t err;
#define LAUNCH_PIPELINE(S)                                                      \
  err = cudaFuncSetAttribute(stream_pipeline_kernel<S>,                         \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
  if (err != cudaSuccess) return err;                                           \
  stream_pipeline_kernel<S><<<blocks, threads, smem, s>>>(gp, partials,         \
                                                          n_chunks, chunk_pieces);
  switch (stages) {
    case 2: LAUNCH_PIPELINE(2) break;
    case 4: LAUNCH_PIPELINE(4) break;
    case 8: LAUNCH_PIPELINE(8) break;
    default: return -1;
  }
#undef LAUNCH_PIPELINE
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<kCols / 8, 8 * kFinishParts, 0, s>>>(partials, out, blocks);
  return cudaGetLastError();
}

// As probe_stream_pipeline, the ring filled by cp.async.bulk.
extern "C" int probe_stream_bulk(const void* g, float* partials, float* out,
                                 int64_t rows, int threads, int stages,
                                 int chunk_rows, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!threads_ok(threads) || blocks < 1 || chunk_rows < 1) return -1;
  const int chunk_pieces = chunk_rows * kPiecesPerRow;
  if (rows % chunk_rows || chunk_pieces % threads) return -1;
  const int64_t n_chunks = rows / chunk_rows;
  const int smem = stages * chunk_pieces * 16;
  if (smem > 200 * 1024) return -1;  // the ring beside 16 KB for the partials
  const uint4* gp = static_cast<const uint4*>(g);
  cudaError_t err;
#define LAUNCH_BULK(S)                                                          \
  err = cudaFuncSetAttribute(stream_bulk_kernel<S>,                             \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
  if (err != cudaSuccess) return err;                                           \
  stream_bulk_kernel<S><<<blocks, threads, smem, s>>>(gp, partials, n_chunks,   \
                                                      chunk_pieces);
  switch (stages) {
    case 2: LAUNCH_BULK(2) break;
    case 4: LAUNCH_BULK(4) break;
    case 8: LAUNCH_BULK(8) break;
    default: return -1;
  }
#undef LAUNCH_BULK
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<kCols / 8, 8 * kFinishParts, 0, s>>>(partials, out, blocks);
  return cudaGetLastError();
}
