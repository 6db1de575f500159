// 2x2-neighbourhood row packing of multi-scale deformable attention for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel tair_tpu/ops/patchify.py::_patchify_level_kernel
// (driven once per feature level by _patchify_level_pallas). For every head
// and every position (y, x) of every level,
//   out[(b*H + h)*S + s, :] = [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)]
// with s the position's token, each v a D-wide row of value[b, :, h, :], and
// zeros for a neighbour past the level's right or bottom border.
//
// Bound on this card: bytes. Nothing is computed: value is read once and an
// output four times its size is written once, so the least time is
// (|value| + |out|) over the memory rate.
//
// Design (patchify_band_kernel, the one the wrapper launches). One launch for
// all levels, heads and batch elements; each block owns one tile of a table
// that the wrapper builds once per geometry (ops/patchify.py::band_schedule):
// a band of `rows` image rows of one level of one batch element, for a group of
// G heads, and all the level's columns unless two rows of them do not fit the
// slab (then a run of `cols` columns). Each choice answers one cost of a
// bytes-bound copy:
//   - Read each value byte from device memory once, in whole lines. The block
//     copies its band plus the one row (and column) below (and right of) it
//     into a shared-memory slab with cp.async, 16-byte pieces along each
//     token's contiguous run of G*D values, every copy in flight at once. The
//     four corners are then built from shared memory. The re-read of the row
//     below costs (R+1)/R of value's bytes for bands of R rows; the neighbour
//     band's block reads that row too, so the second read mostly hits L2.
//   - Write each output sector once, whole. For one head the band's output
//     rows are one contiguous run of rows*wl*4D values; a thread owns one fixed
//     16-byte piece of an output row (a corner and a piece of D) and walks the
//     band's columns, so a warp stores 512 contiguous bytes and every thread
//     has several independent stores in flight (the loop is unrolled). Ordinary
//     stores leave the table in L2 for the row gather that reads it next
//     (streaming .cs stores were timed against them on the spotter's own pass,
//     PERF.md, and did not win by a clear margin).
//   - No per-thread level search or division chain: the tile's level, band and
//     head group are one table entry per block; a thread does two divisions
//     once, to find its piece, and none per piece. Border zeros are decided
//     once per image row (the bottom) and by one compare per piece (the right).
// The slab is at most kSlabBytes (96 KiB), so at least two blocks fit on an SM
// whatever the geometry; the wrapper's tiles (2 heads, 64-token bands at the
// spotter's shape) stage far less.
//
// patchify_per_piece_kernel is the first design, kept under its own entry point
// only so that chip_smoke.py can time the two in turns: one 16-byte piece per
// thread, found by a level search and four divisions, read from value through
// the strides (four times in all, once per corner that reads it) and stored.
//
// Both kernels move raw 16-byte pieces and so serve every element size that
// divides 16; value is read through its strides, never copied.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kSlabBytes = 96 * 1024;
constexpr int kTileInts = 9;  // b, h0, start, hl, wl, y0, rows, x0, cols

// Strides are in 16-byte pieces; vpd = pieces in one D-wide row, G = heads of
// a tile. tiles holds kTileInts ints per block (see the wrapper).
__global__ void __launch_bounds__(kThreads)
patchify_band_kernel(const uint4* __restrict__ value, uint4* __restrict__ out,
                     const int* __restrict__ tiles, int S, int H, int vpd, int G,
                     int64_t stride_b, int64_t stride_s, int64_t stride_h) {
  extern __shared__ uint4 slab[];  // [srows][scols][G][vpd]
  const int* t = tiles + static_cast<int64_t>(blockIdx.x) * kTileInts;
  const int b = t[0], h0 = t[1], start = t[2], hl = t[3], wl = t[4];
  const int y0 = t[5], rows = t[6], x0 = t[7], cols = t[8];
  const int srows = rows + (y0 + rows < hl);  // the row below, if the level has it
  const int scols = cols + (x0 + cols < wl);  // the column to the right, likewise
  const int gv = G * vpd;                     // pieces of one token in the slab

  // 1. stage: thread -> one fixed piece k of a token, every tpr-th token
  {
    const int tpr = kThreads / gv;
    const int k = threadIdx.x % gv;
    const int xs = threadIdx.x / gv;
    if (xs < tpr) {
      const int hh = k / vpd;
      const uint4* src = value + b * stride_b + (h0 + hh) * stride_h + (k - hh * vpd) +
                         (start + static_cast<int64_t>(y0) * wl + x0) * stride_s;
      uint4* dst = slab + k;
      for (int r = 0; r < srows; ++r) {
        for (int x = xs; x < scols; x += tpr)
          tc::cp_async_16(dst + x * gv, src + x * stride_s, true);
        src += wl * stride_s;
        dst += scols * gv;
      }
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
  }

  // 2. write: thread -> one fixed piece q of an output row, every rpp-th column
  const int ppr = 4 * vpd;
  const int rpp = kThreads / ppr;
  const int q = threadIdx.x % ppr;
  const int xo = threadIdx.x / ppr;
  if (xo >= rpp) return;
  const int corner = q / vpd;
  const int p = q - corner * vpd;
  const int dy = corner >> 1, dx = corner & 1;
  // the right neighbour of the level's last column is a zero
  const int xend = (dx && x0 + cols == wl) ? cols - 1 : cols;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int hh = 0; hh < G; ++hh) {
    uint4* o = out + (static_cast<int64_t>(b * H + h0 + hh) * S + start +
                      static_cast<int64_t>(y0) * wl + x0) * ppr + q;
    const uint4* s = slab + (dy * scols + dx) * gv + hh * vpd + p;
    for (int r = 0; r < rows; ++r) {
      const bool row_ok = y0 + r + dy < hl;  // the bottom neighbour exists
#pragma unroll 4
      for (int x = xo; x < cols; x += rpp) {
        o[x * ppr] = (row_ok && x < xend) ? s[x * gv] : zero;
      }
      o += static_cast<int64_t>(wl) * ppr;
      s += scols * gv;
    }
  }
}

struct Levels {
  int n;
  int start[kMaxLevels];  // first token of the level
  int hl[kMaxLevels];
  int wl[kMaxLevels];
};

// The first design. Grid: x over the S * 4 * vpd pieces of one (b, h), y over
// b * H + h, so that a thread finds its token and its piece with 32-bit
// arithmetic.
__global__ void __launch_bounds__(kThreads)
patchify_per_piece_kernel(const uint4* __restrict__ value, uint4* __restrict__ out, int S,
                          int H, int vpd, int64_t stride_b, int64_t stride_s,
                          int64_t stride_h, Levels lv) {
  const int vpr = 4 * vpd;  // pieces in one output row
  const int at = blockIdx.x * kThreads + threadIdx.x;
  if (at >= S * vpr) return;
  const int s = at / vpr;
  const int piece = at - s * vpr;
  const int corner = piece / vpd;
  const int col = piece - corner * vpd;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;

  int lvl = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < lv.n && s >= lv.start[i]) lvl = i;
  const int wl = lv.wl[lvl];
  const int pos = s - lv.start[lvl];
  const int y = pos / wl;
  const int x = pos - y * wl;
  const int dy = corner >> 1;
  const int dx = corner & 1;

  uint4 piece_bits = make_uint4(0u, 0u, 0u, 0u);
  if (x + dx < wl && y + dy < lv.hl[lvl]) {
    const int64_t src = s + dy * wl + dx;
    piece_bits = value[b * stride_b + src * stride_s + h * stride_h + col];
  }
  out[(static_cast<int64_t>(blockIdx.y) * S + s) * vpr + piece] = piece_bits;
}

// 16-byte pieces in one element row of D, or 0 when the element size does not
// divide 16 or a stride or D is not a whole number of pieces
int pieces_per_row(int D, int elem_bytes, int64_t stride_b, int64_t stride_s,
                   int64_t stride_h) {
  if (elem_bytes <= 0 || 16 % elem_bytes) return 0;
  const int per = 16 / elem_bytes;
  if (D <= 0 || D % per || stride_b % per || stride_s % per || stride_h % per) return 0;
  return D / per;
}

}  // namespace

// value [B, S, H, D] with unit stride along D and every row on a 16-byte
// boundary; strides in elements. out [B*H*S, 4*D] contiguous, same element
// size. tiles: n_tiles entries of kTileInts ints on the device, from the
// wrapper's band schedule, each tile's head group of G heads; slab_bytes the
// largest tile's staged bytes. Returns the CUDA error code of the launch (0 on
// success), -1 for a shape that has no kernel.
extern "C" int patchify_value_fwd(const void* value, void* out, const int* tiles,
                                  int n_tiles, int S, int H, int D, int G, int elem_bytes,
                                  int64_t stride_b, int64_t stride_s, int64_t stride_h,
                                  int slab_bytes, void* stream) {
  const int vpd = pieces_per_row(D, elem_bytes, stride_b, stride_s, stride_h);
  if (!vpd || 4 * vpd > kThreads || G < 1 || G * vpd > kThreads || H % G) return -1;
  if (slab_bytes < 0 || slab_bytes > kSlabBytes) return -1;
  if (n_tiles == 0) return 0;
  const int per = 16 / elem_bytes;
  if (slab_bytes > 48 * 1024) {
    // above 48 KB only after an opt-in, made once per device
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return -1;
    if (!opted_in[dev]) {
      err = cudaFuncSetAttribute(patchify_band_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabBytes);
      if (err != cudaSuccess) return err;
      opted_in[dev] = true;
    }
  }
  patchify_band_kernel<<<n_tiles, kThreads, slab_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(value), static_cast<uint4*>(out), tiles, S, H, vpd, G,
      stride_b / per, stride_s / per, stride_h / per);
  return cudaGetLastError();
}

// The first design's entry, with the same value/out contract; level_hw holds
// (hl, wl) of each level, on the host.
extern "C" int patchify_value_fwd_per_piece(const void* value, void* out, int64_t B,
                                            int S, int H, int D, int elem_bytes,
                                            int64_t stride_b, int64_t stride_s,
                                            int64_t stride_h, const int* level_hw,
                                            int n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return -1;
  const int vpd = pieces_per_row(D, elem_bytes, stride_b, stride_s, stride_h);
  if (!vpd) return -1;
  const int per = 16 / elem_bytes;
  Levels lv;
  lv.n = n_levels;
  int64_t tokens = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < n_levels;
    lv.start[i] = static_cast<int>(tokens);
    lv.hl[i] = used ? level_hw[2 * i] : 1;
    lv.wl[i] = used ? level_hw[2 * i + 1] : 1;
    if (used) {
      if (lv.hl[i] < 1 || lv.wl[i] < 1) return -1;
      tokens += static_cast<int64_t>(lv.hl[i]) * lv.wl[i];
    }
  }
  if (tokens != S) return -1;
  const int64_t row_pieces = static_cast<int64_t>(S) * 4 * vpd;  // of one (b, h)
  if (B * H == 0 || row_pieces == 0) return 0;
  if (B * H > 65535 || row_pieces > 0x7fffff00LL) return -1;
  const dim3 grid(static_cast<unsigned>((row_pieces + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B * H));
  patchify_per_piece_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(value), static_cast<uint4*>(out), S, H, vpd,
      stride_b / per, stride_s / per, stride_h / per, lv);
  return cudaGetLastError();
}
