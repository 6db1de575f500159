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
// output four times its size is written once. The three neighbour reads of a
// row hit L2, so the least time is (|value| + |out|) over the memory rate.
//
// Design: one launch for all levels and all heads (a 2D grid: pieces of one
// head's rows by batch x head). A thread moves one 16-byte piece of one output
// row, so the stores of a warp are contiguous. It finds its
// level in a table of at most 8 levels passed by value, reads its piece of the
// neighbour's row straight from value[B, S, H, D] through the strides (no
// transposed copy of value is ever made), or stores zeros past the border. The
// kernel moves raw 16-byte pieces and so serves every element size that
// divides 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int start[kMaxLevels];  // first token of the level
  int hl[kMaxLevels];
  int wl[kMaxLevels];
};

// Strides are in 16-byte pieces. vpd = pieces in one D-wide row. Grid: x over
// the S * 4 * vpd pieces of one (b, h), y over b * H + h, so that a thread finds
// its token and its piece with 32-bit arithmetic.
__global__ void __launch_bounds__(kThreads)
patchify_kernel(const uint4* __restrict__ value, uint4* __restrict__ out, int S,
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

}  // namespace

// value [B, S, H, D] with unit stride along D and every row on a 16-byte
// boundary; strides in elements. out [B*H*S, 4*D] contiguous, same element
// size. level_hw holds (hl, wl) of each level, on the host. Returns the CUDA
// error code of the launch (0 on success), -1 for a shape that has no kernel.
extern "C" int patchify_value_fwd(const void* value, void* out, int64_t B,
                                  int S, int H, int D, int elem_bytes,
                                  int64_t stride_b, int64_t stride_s,
                                  int64_t stride_h, const int* level_hw,
                                  int n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return -1;
  if (elem_bytes <= 0 || 16 % elem_bytes) return -1;
  const int per = 16 / elem_bytes;  // elements in one 16-byte piece
  if (D % per || stride_b % per || stride_s % per || stride_h % per) return -1;
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
  const int vpd = D / per;
  const int64_t row_pieces = static_cast<int64_t>(S) * 4 * vpd;  // of one (b, h)
  if (B * H == 0 || row_pieces == 0) return 0;
  if (B * H > 65535 || row_pieces > 0x7fffff00LL) return -1;
  const dim3 grid(static_cast<unsigned>((row_pieces + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B * H));
  patchify_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(value), static_cast<uint4*>(out), S, H, vpd,
      stride_b / per, stride_s / per, stride_h / per, lv);
  return cudaGetLastError();
}
