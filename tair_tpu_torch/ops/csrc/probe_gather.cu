// Probe of an in-kernel gather along the last axis on Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU probe scripts/dyngather_probe.py (_gather_kernel, the check,
// and _rate_kernel, the rate), which asked whether take_along_axis lowers inside
// a kernel and how fast it runs with the table resident on chip:
//   out[g, c, r, j] = x[g, r, idx[g, c, r, j]]
// with x [G, R, S], idx [G, C, R, J] int32 and out [G, C, R, J]; an index outside
// [0, S) is clamped, as the TPU gather does.
//
// Bound on this card: bytes. idx is read once and out written once, each as
// large as the other for 4-byte outputs; x is small beside them. No arithmetic.
//
// The question here is where the table should live for a fused msda kernel.
// Two kernels answer it:
//   global  every thread takes four indices with one 16-byte load, gathers the
//           four values straight from global memory (x is a few MB and stays in
//           the 50 MB L2) and stores them with one vector store;
//   shared  a block first copies a slab of rows of x[g] into shared memory, as
//           many as fit beside nothing else (the host picks the count from the
//           227 KB a block may use), then gathers from the slab for its share
//           of the C index planes. Random reads of shared memory meet bank
//           conflicts; random reads of L2 meet its sector granularity. The
//           probe measures which costs less.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedThreads = 1024;
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90

template <typename TI, typename TO>
__device__ inline TO convert(TI v) { return v; }
template <>
__device__ inline float convert<__nv_bfloat16, float>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TO>
__device__ inline void store4(TO* p, const TO* v);
template <>
__device__ inline void store4<uint32_t>(uint32_t* p, const uint32_t* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ inline void store4<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ inline void store4<uint16_t>(uint16_t* p, const uint16_t* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      static_cast<uint32_t>(v[0]) | (static_cast<uint32_t>(v[1]) << 16),
      static_cast<uint32_t>(v[2]) | (static_cast<uint32_t>(v[3]) << 16));
}

__device__ inline int clampi(int i, int n) { return min(max(i, 0), n - 1); }

// One thread per four consecutive outputs; J is a multiple of 4.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
gather_global_kernel(const TI* __restrict__ x, const int* __restrict__ idx,
                     TO* __restrict__ out, int64_t n_quads, int C, int R, int S,
                     int J) {
  const int64_t quads_per_row = J / 4;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < n_quads; t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = t / quads_per_row;  // (g, c, r) flattened
    const int r = static_cast<int>(row % R);
    const int64_t g = row / (static_cast<int64_t>(R) * C);
    const TI* xr = x + (g * R + r) * S;
    const int4 i4 = reinterpret_cast<const int4*>(idx)[t];
    TO v[4];
    v[0] = convert<TI, TO>(xr[clampi(i4.x, S)]);
    v[1] = convert<TI, TO>(xr[clampi(i4.y, S)]);
    v[2] = convert<TI, TO>(xr[clampi(i4.z, S)]);
    v[3] = convert<TI, TO>(xr[clampi(i4.w, S)]);
    store4<TO>(out + t * 4, v);
  }
}

// grid (slabs of rows, G, shares of C). The block's slab holds rows
// [r0, r0 + rows) of x[g], row-major, S values each.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kSharedThreads)
gather_shared_kernel(const TI* __restrict__ x, const int* __restrict__ idx,
                     TO* __restrict__ out, int C, int R, int S, int J,
                     int slab_rows, int c_per_block) {
  extern __shared__ __align__(16) unsigned char slab_bytes[];
  TI* slab = reinterpret_cast<TI*>(slab_bytes);
  const int r0 = blockIdx.x * slab_rows;
  const int rows = min(slab_rows, R - r0);
  const int64_t g = blockIdx.y;
  const int c0 = blockIdx.z * c_per_block;
  const int c1 = min(c0 + c_per_block, C);

  const TI* xs = x + (g * R + r0) * S;
  for (int i = threadIdx.x; i < rows * S; i += kSharedThreads) slab[i] = xs[i];
  __syncthreads();

  const int quads_per_row = J / 4;
  const int per_plane = rows * quads_per_row;
  for (int c = c0; c < c1; ++c) {
    const int64_t plane = ((g * C + c) * R + r0) * static_cast<int64_t>(J);
    for (int t = threadIdx.x; t < per_plane; t += kSharedThreads) {
      const int r = t / quads_per_row;
      const TI* sr = slab + r * S;
      const int4 i4 = reinterpret_cast<const int4*>(idx + plane)[t];
      TO v[4];
      v[0] = convert<TI, TO>(sr[clampi(i4.x, S)]);
      v[1] = convert<TI, TO>(sr[clampi(i4.y, S)]);
      v[2] = convert<TI, TO>(sr[clampi(i4.z, S)]);
      v[3] = convert<TI, TO>(sr[clampi(i4.w, S)]);
      store4<TO>(out + plane + static_cast<int64_t>(t) * 4, v);
    }
  }
}

int slab_rows_for(int R, int S, int elem_bytes) {
  const int64_t fit = kMaxShared / (static_cast<int64_t>(S) * elem_bytes);
  return static_cast<int>(fit < R ? fit : R);
}

template <typename TI, typename TO>
int launch_global(const void* x, const int* idx, void* out, int G, int C, int R,
                  int S, int J, cudaStream_t stream) {
  const int64_t n_quads = static_cast<int64_t>(G) * C * R * (J / 4);
  if (n_quads == 0) return 0;
  int64_t blocks = (n_quads + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  gather_global_kernel<TI, TO><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(static_cast<const TI*>(x), idx,
                                           static_cast<TO*>(out), n_quads, C, R,
                                           S, J);
  return cudaGetLastError();
}

template <typename TI, typename TO>
int launch_shared(const void* x, const int* idx, void* out, int G, int C, int R,
                  int S, int J, int c_split, cudaStream_t stream) {
  const int slab_rows = slab_rows_for(R, S, sizeof(TI));
  if (slab_rows < 1 || c_split < 1) return -1;
  if (G == 0 || C == 0 || R == 0 || J == 0) return 0;
  const int slabs = (R + slab_rows - 1) / slab_rows;
  const int c_per_block = (C + c_split - 1) / c_split;
  const int shares = (C + c_per_block - 1) / c_per_block;
  const int smem = slab_rows * S * static_cast<int>(sizeof(TI));
  cudaError_t err = cudaFuncSetAttribute(
      gather_shared_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  gather_shared_kernel<TI, TO><<<dim3(slabs, G, shares), kSharedThreads, smem,
                                 stream>>>(static_cast<const TI*>(x), idx,
                                           static_cast<TO*>(out), C, R, S, J,
                                           slab_rows, c_per_block);
  return cudaGetLastError();
}

}  // namespace

// Rows of x[g] that one block's slab holds for this row length and element size.
extern "C" int probe_gather_slab_rows(int R, int S, int elem_bytes) {
  return slab_rows_for(R, S, elem_bytes);
}

// x [G, R, S], idx [G, C, R, J] int32, out [G, C, R, J], all contiguous and
// aligned to 16 bytes, J a multiple of 4. in_type: 0 four-byte values (float32,
// int32), 1 bfloat16. out_float: 1 widens bfloat16 to float32, 0 keeps the
// input's type. where: 0 global, 1 shared (c_split shares of the C planes per
// slab). Returns the CUDA error code of the launch, -1 for what has no kernel.
extern "C" int probe_gather(const void* x, const int* idx, void* out, int G,
                            int C, int R, int S, int J, int in_type,
                            int out_float, int where, int c_split,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J % 4 || S < 1) return -1;
  if (in_type == 0 && !out_float)
    return where ? launch_shared<uint32_t, uint32_t>(x, idx, out, G, C, R, S, J, c_split, s)
                 : launch_global<uint32_t, uint32_t>(x, idx, out, G, C, R, S, J, s);
  if (in_type == 1 && !out_float)
    return where ? launch_shared<uint16_t, uint16_t>(x, idx, out, G, C, R, S, J, c_split, s)
                 : launch_global<uint16_t, uint16_t>(x, idx, out, G, C, R, S, J, s);
  if (in_type == 1 && out_float)
    return where ? launch_shared<__nv_bfloat16, float>(x, idx, out, G, C, R, S, J, c_split, s)
                 : launch_global<__nv_bfloat16, float>(x, idx, out, G, C, R, S, J, s);
  return -1;
}
