// Warp-level tensor-core building blocks of the bf16 flash attention kernels:
// mma.sync m16n8k16 (bf16 in, float accumulators), ldmatrix from shared memory,
// cp.async copies from global to shared memory, and the conversions between an
// accumulator fragment and an A operand fragment.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = threadIdx.x % 32,
// g = lane / 4, c = 2 * (lane % 4):
//   A, 16 x 16 row-major: a[0] = (g, c..c+1), a[1] = (g+8, c..c+1),
//                         a[2] = (g, c+8..c+9), a[3] = (g+8, c+8..c+9)
//   B, 16 x 8 (k x n):    b[0] = (k c..c+1, n g), b[1] = (k c+8..c+9, n g)
//   C, 16 x 8 float:      c[0..1] = (g, c..c+1), c[2..3] = (g+8, c..c+1)
// So the C fragments of two neighbouring 8-column tiles are, rounded to bf16,
// the A fragment of one 16-deep step (`a_from_c`): a product's output feeds the
// next product from registers, with no trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !pred (nothing is read,
// but src must still be a valid address)
__device__ inline void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero when !pred
__device__ inline void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies a rows x cols bf16 tile (cols a multiple of 8, rows 16-byte aligned in
// global memory) into shared memory with row pitch ld, by the block's nthreads
// threads; rows at or past valid (>= 1) are zero-filled.
__device__ inline void load_rows_async(bf16* dst, int ld, const bf16* src,
                                       int64_t row_stride, int rows, int valid,
                                       int cols, int nthreads) {
  const int cpr = cols / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * cpr; i += nthreads) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * ld + c, src + (ok ? static_cast<int64_t>(r) * row_stride : 0) + c, ok);
  }
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b
__device__ inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = hi + lo with hi = bf16(x, y) and lo = bf16((x, y) - hi): two bf16
// terms carry about 16 bits of each value, where one carries 8
__device__ inline void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x - hf.x, y - hf.y);
}

// The A fragments (hi and lo terms) of the 16 x 16 block whose columns are the
// C fragments c0 (columns 0-7) and c1 (columns 8-15).
__device__ inline void a_from_c(const float (&c0)[4], const float (&c1)[4],
                                uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// Row addresses for ldmatrix_x4 over a 16 x 16 block at (row0, col0) of a
// row-major shared tile with pitch ld. As A operand (non-trans), matrices are
// (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15),
// (rows 8-15, cols 8-15): a[0..3]. The same call .trans on a [k][n] tile gives
// b0, b1 of the n-tile col0 and b0, b1 of the n-tile col0 + 8.
__device__ inline const bf16* a_rows(const bf16* tile, int ld, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 + (lane >> 4) * 8;
}

// Row addresses for ldmatrix_x4 (non-trans) of B operands from an [n][k] tile
// (n rows of k contiguous values: K as the B of Q K^T): matrices (n 0-7, k 0-7),
// (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) give b0, b1 of the n-tile
// row0 and b0, b1 of the n-tile row0 + 8.
__device__ inline const bf16* b_rows(const bf16* tile, int ld, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + (lane >> 4) * 8) * ld + col0 + ((lane >> 3) & 1) * 8;
}

}  // namespace tc
