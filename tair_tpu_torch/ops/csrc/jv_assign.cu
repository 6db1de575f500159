// Kernel J1: exact linear sum assignment of many cost matrices in one launch
// (Jonker-Volgenant shortest augmenting paths): a warp for each narrow matrix,
// a thread block for each wide one.
//
// Replaces the JAX package's on-device solve, tair_tpu/spotter/matcher.py::
// _jv_single (:86-177) and jv_assignment (:180-211): lax while loops that XLA
// compiles, no Pallas kernel. Its plain version is
// tair_tpu_torch/spotter/matcher.py::jv_assignment_reference; this kernel
// computes the same float32 values in the same order and takes the same
// first-index argmin, so the assignment equals both bit for bit, ties included.
//
// What bounds it on the H100. By the bytes it must move (each cost read once,
// each assignment written once), a training step's seven matrices need
// about 1e-4 ms (9.8e-7 ms for the decoder's 100 x 8 matrix); no operation
// count comes near. What limits it is the chain of dependent Dijkstra steps:
// each step relaxes the remaining columns against the row that joined the
// tree last and takes their argmin, and only that argmin names the next row.
// A solve is `search_steps` such steps in a row (11-14 for the decoder's 100
// x 8 matrix of the train step, 3,491 at 300 x 256), so its time is the steps
// times the latency of one step, plus a launch. The earlier design (a block
// per matrix, a thread per column, a launch per batch) paid about 1.1 us a
// step (a block barrier, and every thread merging the warps' partials in
// turn) and seven launches a training step.
//
// The design:
// - One launch for many matrices. The wrapper hands a table of matrices
//   (cost, n_valid, out, workspace, Q, M) to the kernel as a parameter, so
//   the table costs no copy and no host sync. A training step's seven
//   matchings (the last decoder layer, the five auxiliary ones, the encoder
//   proposals) are one launch: the narrow matrices are solved beside the wide
//   one, and the call takes about the wide one's time.
// - A warp for each matrix of at most kWarpMaxCols = 256 solved columns whose
//   A and vectors fit in a block's shared memory (the warp path beat the
//   block path at every width measured, 64 to 256 columns; 256 is eight
//   columns a lane, the most the registers hold; read in place, A cost the
//   warp 2 us a step at 256 x 256, the block path's workspace 0.75). Column
//   c = lane + 32 k lives in the lane's registers (v, spc, path and a tree
//   bit): a step reads only u[i] and row i of A (staged in the warp's slice
//   of shared memory; a block holds fewer warps when the slices are large),
//   relaxes K columns from registers, and takes the argmin by two warp reductions
//   (__reduce_min_sync) of an order-preserving key of the value, then of the
//   index among the lanes holding the least key, so the first index wins a
//   tie. No block barrier: __syncwarp around the dual update only. About
//   0.35 us a step against the earlier design's 0.7-1.3 (H100, chip_smoke.py
//   phase matcher). A block holds several such warps, each on its own matrix.
// - A thread block for each wider matrix (the encoder's 9472 proposals, the
//   37,888-token case): each warp's argmin by the same two reductions, one
//   barrier, then every warp reduces the warps' partials the same way (the
//   partials double-buffered: one barrier a step). A thread's columns are
//   relaxed four at a time, their loads issued first, so a step waits for
//   one round trip a batch, not one a column. The columns a search adds to the
//   tree are listed, so the dual update and the reset touch those alone (the
//   first step of a search rewrites every spc). kBlockThreads = 512 threads
//   (the best of 128, 256 and 512 measured at [1, 9472, 8]; 1024 would leave
//   64 registers a thread, and the warp path spills there). The solved
//   matrix is staged in shared memory when it fits beside the vectors, else
//   in the workspace, transposed when it is target-major, so a step reads one
//   contiguous row (read in place, a target of a [Q, 8] cost is a column,
//   each float a 32-byte sector: 0.25 ms against 0.21 staged at [1, 37888,
//   8]). The vectors live in shared memory when they fit (up to about 13,000
//   columns), else in the workspace.

// Layout. A matrix: cost [Q, M] float32 (queries x target slots), n_valid one
// int64, out [M] int64 (query per target, -1 for padded or unmatched targets).
// With M <= Q it is solved target-major: row r < M is target r, column c < Q is
// query c, A[r][c] = cost[c][r] for r < n_valid and 0 for padded rows. With
// M > Q it is solved query-major: row r < Q is query r, column c < M is
// target c, A[r][c] = cost[r][c] for c < n_valid and 1e6 for padded columns;
// the result is read back through row4col (the inverse assignment). Rows <=
// columns either way, so every row's search reaches a free column within
// `cols` steps; both loops are bounded, so no input (NaN included) hangs the
// card. A candidate is never NaN (a NaN relaxation fails `r < spc`) and never
// -0 (min_val starts at +0, and x - y = -0 needs x = -0), so the key order is
// the float order and the key maps back to the value's bits.
//
// Arithmetic: only adds and subtracts, each written as __fadd_rn / __fsub_rn,
// which the compiler never contracts or reorders:
//   r        = ((min_val + A[i][c]) - u[i]) - v[c]
//   u[other] = u[other] + (min_val - spc[col4row[other]])
//   v[tree]  = v[tree] - (min_val - spc[tree])
// as JAX evaluates them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kInf = 1e30f;  // JV_INF of the plain version
constexpr float kPad = 1e6f;   // JV_PAD
constexpr int kBlockThreads = 512;  // a wide matrix's block: 128 registers a thread
constexpr int kWarpMaxCols = 256;   // the most solved columns a warp takes (K = 8 a lane)
constexpr int kBlockBatch = 4;      // columns a thread of a block relaxes at a time
constexpr int kMaxDevices = 64;
constexpr int kMaxMatrices = 64;   // a launch's table is a kernel parameter (under 4 KB)
constexpr int kWarpsPerBlock = 4;  // warp matrices a block when no matrix takes a block
constexpr int kTreeList = 512;     // a block's record of the columns a search adds to the tree
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // a key and an index above every candidate's

// where a block matrix's A and vectors live: A in shared memory or else in
// the workspace, its vectors in shared memory unless flagged (a warp
// matrix's live in its slice of shared memory)
enum : int { kAInShared = 1, kVectorsInWorkspace = 2 };

struct Matrix {
  const float* cost;       // [Q, M]
  const int64_t* n_valid;  // its count of valid targets
  int64_t* out;            // [M]
  unsigned char* ws;       // its workspace (A first, then the vectors), or null
  int Q, M, flags, pad;
};

struct Table {
  Matrix m[kMaxMatrices];
  int n_block;          // matrices [0, n_block) take a block each
  int n_total;          // matrices [n_block, n_total) take a warp each
  int warps_per_block;  // warp matrices a block
  int warp_slice;       // bytes of shared memory a warp's matrix gets
};

__host__ __device__ constexpr int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

// v spc row4col path sc a column; u col4row sr a row
__host__ __device__ constexpr int64_t vector_bytes(int64_t rows, int64_t cols) {
  return align16(cols * (4 + 4 + 4 + 4 + 1) + rows * (4 + 4 + 1));
}

struct Vectors {
  float* v;         // column duals
  float* spc;       // shortest path cost to each column in this row's search
  float* u;         // row duals
  int* row4col;
  int* path;
  int* col4row;
  unsigned char* sc;  // column in the tree
  unsigned char* sr;  // row in the tree
};

__device__ __forceinline__ Vectors carve(unsigned char* base, int R, int C) {
  Vectors s;
  s.v = reinterpret_cast<float*>(base);
  s.spc = s.v + C;
  s.u = s.spc + C;
  s.row4col = reinterpret_cast<int*>(s.u + R);
  s.path = s.row4col + C;
  s.col4row = s.path + C;
  s.sc = reinterpret_cast<unsigned char*>(s.col4row + R);
  s.sr = s.sc + C;
  return s;
}

__device__ __forceinline__ float solved_entry(const float* __restrict__ cost, int r, int c,
                                              int M, bool target_major, int64_t nv) {
  if (target_major) return r < nv ? __ldg(cost + static_cast<int64_t>(c) * M + r) : 0.0f;
  return c >= nv ? kPad : __ldg(cost + static_cast<int64_t>(r) * M + c);
}

// An unsigned key in the order of the floats (none is NaN or -0 here), and back.
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The warp's least (key, index): the least key, then the least index of it.
__device__ __forceinline__ void warp_argmin(unsigned& key, unsigned& idx) {
  const unsigned least = __reduce_min_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == least ? idx : kNone);
  key = least;
}

// Stages A row-major [R, C] (rows `stride` floats apart) at `A` (shared
// memory or the workspace), padding and masking as solved_entry does. Loads
// are issued kBatch at a time, so a thread waits for one round trip a batch,
// not one an element.
template <int kBatch>
__device__ __forceinline__ void stage(float* A, int64_t stride, const float* __restrict__ cost,
                                      int Q, int M, int R, int C, bool target_major, int64_t nv,
                                      int tid, int nt) {
  if (target_major && R <= kBatch) {
    // a thread a query: its targets are neighbours in cost; each target's row
    // is written contiguously across the threads
    for (int c0 = tid; c0 < C; c0 += 2 * nt) {
      float x[2][kBatch];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + h * nt;
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          if (c < C && r < R) x[h][r] = solved_entry(cost, r, c, M, true, nv);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + h * nt;
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          if (c < C && r < R) A[r * stride + c] = x[h][r];
        }
      }
    }
    return;
  }
  // cost read in its own order (coalesced), stored as the solved matrix
  const int64_t n = static_cast<int64_t>(Q) * M;
  for (int64_t e0 = tid; e0 < n; e0 += static_cast<int64_t>(kBatch) * nt) {
    float x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t e = e0 + static_cast<int64_t>(k) * nt;
      if (e < n) x[k] = __ldg(cost + e);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t e = e0 + static_cast<int64_t>(k) * nt;
      if (e < n) {
        const int qi = static_cast<int>(e / M), mi = static_cast<int>(e - static_cast<int64_t>(qi) * M);
        const int r = target_major ? mi : qi, c = target_major ? qi : mi;
        const float a = target_major ? (r < nv ? x[k] : 0.0f) : (c >= nv ? kPad : x[k]);
        A[r * stride + c] = a;
      }
    }
  }
}

// The augmenting walk along path back to row cur, by one thread.
__device__ __forceinline__ void augment(const Vectors& s, int sink, int cur, int R) {
  int j = sink;
  for (int k = 0; k < R; ++k) {
    const int pi = s.path[j];
    if (pi < 0) break;
    s.row4col[j] = pi;
    const int next = s.col4row[pi];
    s.col4row[pi] = j;
    if (pi == cur || next < 0) break;
    j = next;
  }
}

// One wide matrix, solved by the whole block; A staged row-major [R, C] in
// shared memory (kShared) or in the workspace; each thread relaxes its
// columns kBatch at a time, every load of a batch first.
template <bool kShared, int kBatch>
__device__ __forceinline__ void solve_block(const Matrix& d, unsigned char* smem, unsigned* red_k,
                                            unsigned* red_i, int* tree_list) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int Q = d.Q, M = d.M;
  const bool target_major = M <= Q;
  const int R = target_major ? M : Q;  // rows: each gets a column
  const int C = target_major ? Q : M;  // columns
  const int64_t nv = *d.n_valid;
  const float* __restrict__ cost = d.cost;

  const int64_t a_bytes = align16(static_cast<int64_t>(R) * C * 4);
  float* A = reinterpret_cast<float*>(kShared ? smem : d.ws);
  unsigned char* vec_base = kShared ? smem + a_bytes : smem;
  if (d.flags & kVectorsInWorkspace) vec_base = d.ws + (kShared ? 0 : a_bytes);
  const Vectors s = carve(vec_base, R, C);

  for (int c = tid; c < C; c += nt) {
    s.v[c] = 0.0f;
    s.spc[c] = kInf;
    s.row4col[c] = -1;
    s.path[c] = -1;
    s.sc[c] = 0;
  }
  for (int r = tid; r < R; r += nt) {
    s.u[r] = 0.0f;
    s.col4row[r] = -1;
    s.sr[r] = 0;
  }
  stage<8>(A, C, cost, Q, M, R, C, target_major, nv, tid, nt);
  __syncthreads();

  int parity = 0;
  for (int cur = 0; cur < R; ++cur) {
    // --- Dijkstra from row cur until a free column is reached ---
    int i = cur, sink = -1, steps = 0;
    float min_val = 0.0f;
    for (int step = 0; step < C; ++step) {
      s.sr[i] = 1;  // every thread writes the same byte: no divergent branch
      const float ui = s.u[i];
      const float* row = A + static_cast<int64_t>(i) * C;
      const bool first = step == 0;  // the tree is empty and every spc is kInf
      unsigned best_k = kNone, best_c = kNone;
      for (int c0 = tid; c0 < C; c0 += kBatch * nt) {
        float a[kBatch], v[kBatch], spc[kBatch];
        unsigned char tree[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {  // every load of the batch first
          const int c = c0 + k * nt;
          if (c < C) {
            a[k] = row[c];
            v[k] = s.v[c];
            spc[k] = first ? kInf : s.spc[c];
            tree[k] = first ? 0 : s.sc[c];
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int c = c0 + k * nt;
          if (c < C) {
            float cand = kInf;  // a column in the tree is masked to kInf
            if (!tree[k]) {
              const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, a[k]), ui), v[k]);
              cand = spc[k];
              if (r < cand) {
                cand = r;
                s.path[c] = i;
              }
              // the first step writes every spc: this row's search starts from kInf
              if (first || cand != spc[k]) s.spc[c] = cand;
            }
            const unsigned key = key_of(cand);
            if (key < best_k) {  // columns ascend: the first of equal keys stays
              best_k = key;
              best_c = c;
            }
          }
        }
      }
      const unsigned mine = best_c;  // only the thread of column j holds j here
      warp_argmin(best_k, best_c);
      if (lane == 0) {
        red_k[parity * 32 + warp] = best_k;
        red_i[parity * 32 + warp] = best_c;
      }
      __syncthreads();
      best_k = lane < n_warps ? red_k[parity * 32 + lane] : kNone;
      best_c = lane < n_warps ? red_i[parity * 32 + lane] : kNone;
      warp_argmin(best_k, best_c);
      parity ^= 1;  // the next step writes the other buffer: one barrier a step
      const int j = static_cast<int>(best_c);
      min_val = value_of(best_k);
      if (mine == best_c) {  // sc[c] is read only by the thread of column c
        if (step < kTreeList) tree_list[step] = s.sc[j] ? -1 : j;  // each column once
        s.sc[j] = 1;
      }
      steps = step + 1;
      const int owner = s.row4col[j];
      if (owner < 0) {
        sink = j;
        break;
      }
      i = owner;
    }

    // --- dual update (scipy _lsap convention) ---
    for (int r = tid; r < R; r += nt) {
      if (r == cur) {
        s.u[r] = __fadd_rn(s.u[r], min_val);
      } else if (s.sr[r]) {
        const int c = s.col4row[r] < 0 ? 0 : s.col4row[r];
        s.u[r] = __fadd_rn(s.u[r], __fsub_rn(min_val, s.spc[c]));
      }
      s.sr[r] = 0;
    }
    __syncthreads();  // the rows' update has read spc and col4row

    // --- augment along the alternating path back to row cur ---
    if (tid == 0 && sink >= 0) augment(s, sink, cur, R);
    // the tree's columns: their duals, and out of the tree (spc is rewritten
    // by the next search's first step; path is read only in the tree)
    if (steps <= kTreeList) {
      for (int t = tid; t < steps; t += nt) {
        const int c = tree_list[t];
        if (c >= 0) {
          s.v[c] = __fsub_rn(s.v[c], __fsub_rn(min_val, s.spc[c]));
          s.sc[c] = 0;
        }
      }
    } else {
      for (int c = tid; c < C; c += nt) {
        if (s.sc[c]) {
          s.v[c] = __fsub_rn(s.v[c], __fsub_rn(min_val, s.spc[c]));
          s.sc[c] = 0;
        }
      }
    }
    __syncthreads();
  }

  for (int t = tid; t < M; t += nt) {
    const int q = target_major ? s.col4row[t] : s.row4col[t];
    d.out[t] = t < nv ? q : -1;
  }
}

// One narrow matrix (at most 32 K columns), solved by one warp. Column c =
// lane + 32 k lives in lane's registers (v, spc, path and the tree bit k);
// spc and path are published to the warp's slice of shared memory once a
// search ends, for the dual update and the augmenting walk. A is staged in
// the slice, before the vectors.
template <int K>
__device__ __forceinline__ void solve_warp(const Matrix& d, unsigned char* slice) {
  const int lane = threadIdx.x & 31;
  const int Q = d.Q, M = d.M;
  const bool target_major = M <= Q;
  const int R = target_major ? M : Q;
  const int C = target_major ? Q : M;
  const int64_t nv = *d.n_valid;
  const float* __restrict__ cost = d.cost;
  float* A = reinterpret_cast<float*>(slice);
  const Vectors s = carve(slice + align16(static_cast<int64_t>(R) * C * 4), R, C);

  float v[K], spc[K];
  int path[K];
  unsigned tree = 0;  // bit k: column lane + 32 k is in the tree
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.0f;
    spc[k] = kInf;
    path[k] = -1;
  }
  for (int c = lane; c < C; c += 32) s.row4col[c] = -1;
  for (int r = lane; r < R; r += 32) {
    s.u[r] = 0.0f;
    s.col4row[r] = -1;
    s.sr[r] = 0;
  }
  stage<8>(A, C, cost, Q, M, R, C, target_major, nv, lane, 32);
  __syncwarp();

  for (int cur = 0; cur < R; ++cur) {
    // --- Dijkstra from row cur until a free column is reached ---
    int i = cur, sink = -1;
    float min_val = 0.0f;
    for (int step = 0; step < C; ++step) {
      s.sr[i] = 1;  // every lane writes the same byte: no divergent branch
      const float ui = s.u[i];
      float a[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {  // every load first
        const int c = lane + 32 * k;
        if (c < C) a[k] = A[static_cast<int64_t>(i) * C + c];
      }
      unsigned best_k = kNone, best_c = kNone;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = lane + 32 * k;
        if (c < C) {
          if (!((tree >> k) & 1u)) {
            const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, a[k]), ui), v[k]);
            if (r < spc[k]) {
              spc[k] = r;
              path[k] = i;
            }
          }
          const unsigned key = key_of((tree >> k) & 1u ? kInf : spc[k]);
          if (key < best_k) {  // columns ascend: the first of equal keys stays
            best_k = key;
            best_c = c;
          }
        }
      }
      const unsigned mine = best_c;  // only the lane of column j holds j here
      warp_argmin(best_k, best_c);
      const int j = static_cast<int>(best_c);
      min_val = value_of(best_k);
      if (mine == best_c) tree |= 1u << (j >> 5);
      const int owner = s.row4col[j];
      if (owner < 0) {
        sink = j;
        break;
      }
      i = owner;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {  // published for the dual update and the walk
      const int c = lane + 32 * k;
      if (c < C) {
        s.spc[c] = spc[k];
        s.path[c] = path[k];
      }
    }
    __syncwarp();

    // --- dual update (scipy _lsap convention) ---
    for (int r = lane; r < R; r += 32) {
      if (r == cur) {
        s.u[r] = __fadd_rn(s.u[r], min_val);
      } else if (s.sr[r]) {
        const int c = s.col4row[r] < 0 ? 0 : s.col4row[r];
        s.u[r] = __fadd_rn(s.u[r], __fsub_rn(min_val, s.spc[c]));
      }
      s.sr[r] = 0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((tree >> k) & 1u) v[k] = __fsub_rn(v[k], __fsub_rn(min_val, spc[k]));
      spc[k] = kInf;
    }
    tree = 0;
    __syncwarp();  // the dual update has read spc and col4row

    // --- augment along the alternating path back to row cur ---
    if (lane == 0 && sink >= 0) augment(s, sink, cur, R);
    __syncwarp();
  }

  for (int t = lane; t < M; t += 32) {
    const int q = target_major ? s.col4row[t] : s.row4col[t];
    d.out[t] = t < nv ? q : -1;
  }
}

__device__ __forceinline__ void solve_warp_any(const Matrix& d, unsigned char* slice) {
  const int C = d.M <= d.Q ? d.Q : d.M;
  if (C <= 32) {
    solve_warp<1>(d, slice);
  } else if (C <= 64) {
    solve_warp<2>(d, slice);
  } else if (C <= 128) {
    solve_warp<4>(d, slice);
  } else {
    solve_warp<8>(d, slice);
  }
}

__global__ void __launch_bounds__(kBlockThreads)
    jv_assign_kernel(const __grid_constant__ Table table) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned red_k[2 * 32];
  __shared__ unsigned red_i[2 * 32];
  __shared__ int tree_list[kTreeList];
  const int b = blockIdx.x;
  if (b < table.n_block) {
    const Matrix& d = table.m[b];
    if (d.flags & kAInShared) {
      solve_block<true, kBlockBatch>(d, smem, red_k, red_i, tree_list);
    } else {
      solve_block<false, kBlockBatch>(d, smem, red_k, red_i, tree_list);
    }
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int k = table.n_block + (b - table.n_block) * table.warps_per_block + warp;
  if (warp >= table.warps_per_block || k >= table.n_total) return;
  const Matrix& d = table.m[k];
  solve_warp_any(d, smem + static_cast<int64_t>(warp) * table.warp_slice);
}

int limits_of_current_device(int* max_dynamic) {
  static int known[kMaxDevices];
  static int limit[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (!known[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, jv_assign_kernel);
    if (err != cudaSuccess) return err;
    limit[dev] = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(jv_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit[dev]);
    if (err != cudaSuccess) return err;
    known[dev] = 1;
  }
  *max_dynamic = limit[dev];
  return 0;
}

// Where one matrix is solved and where its A and vectors live.
struct Plan {
  bool warp = false;
  int flags = 0;
  int64_t shared_bytes = 0;     // a block matrix's dynamic shared memory; a warp's slice
  int64_t workspace_bytes = 0;  // 16-byte multiple
};

Plan plan_of(int Q, int M, int max_dynamic) {
  const bool target_major = M <= Q;
  const int64_t R = target_major ? M : Q, C = target_major ? Q : M;
  const int64_t vectors = vector_bytes(R, C), matrix = R * C * 4;
  Plan plan;
  if (C <= kWarpMaxCols && align16(matrix) + vectors <= max_dynamic) {
    plan.warp = true;  // its slice: A, then the vectors
    plan.shared_bytes = align16(matrix) + vectors;
    return plan;
  }
  if (align16(matrix) + vectors <= max_dynamic) {
    plan.flags = kAInShared;
    plan.shared_bytes = align16(matrix) + vectors;
    return plan;
  }
  plan.workspace_bytes = align16(matrix);  // A staged in the workspace
  if (vectors <= max_dynamic) {
    plan.shared_bytes = vectors;
  } else {
    plan.flags |= kVectorsInWorkspace;
    plan.workspace_bytes += vectors;
  }
  return plan;
}

// a status of this file's C entries: a CUDA error (> 0) or -1, as a negative number
int negated(int err) { return err > 0 ? -err : (err < 0 ? err : 0); }

bool entries_valid(const int64_t* entries, int n) {
  if (n < 0 || (n > 0 && entries == nullptr)) return false;
  for (int e = 0; e < n; ++e) {
    const int64_t* row = entries + 6 * e;
    if (row[3] < 0 || row[4] < 0 || row[5] < 0 || row[4] > 0x7fffffff || row[5] > 0x7fffffff) {
      return false;
    }
  }
  return true;
}

// One launch of up to kMaxMatrices matrices (block matrices first in the
// table). Every warp gets a slice of the largest warp matrix's size, and a
// block holds as many warps as its shared memory has slices for.
int launch(Table& table, int n_block, int n_total, int64_t block_shared, cudaStream_t stream) {
  const int n_warp = n_total - n_block;
  const int threads =
      n_block > 0 ? kBlockThreads : 32 * (n_warp < kWarpsPerBlock ? n_warp : kWarpsPerBlock);
  int warps_per_block = threads / 32;
  int64_t warp_slice = 0;
  if (n_warp > 0) {
    int max_dynamic = 0;
    const int err = limits_of_current_device(&max_dynamic);
    if (err != 0) return err;
    for (int k = n_block; k < n_total; ++k) {
      const Matrix& m = table.m[k];
      const bool target_major = m.M <= m.Q;
      const int64_t R = target_major ? m.M : m.Q, C = target_major ? m.Q : m.M;
      const int64_t bytes = align16(R * C * 4) + vector_bytes(R, C);
      if (bytes > warp_slice) warp_slice = bytes;
    }
    if (max_dynamic / warp_slice < warps_per_block) {
      warps_per_block = static_cast<int>(max_dynamic / warp_slice);
    }
  }
  table.n_block = n_block;
  table.n_total = n_total;
  table.warps_per_block = warps_per_block;
  table.warp_slice = static_cast<int>(warp_slice);
  const int64_t warp_shared = static_cast<int64_t>(warps_per_block) * warp_slice;
  const int64_t shared = block_shared > warp_shared ? block_shared : warp_shared;
  const int grid = n_block + (n_warp + warps_per_block - 1) / warps_per_block;
  jv_assign_kernel<<<grid, threads, static_cast<size_t>(shared), stream>>>(table);
  return cudaGetLastError();
}

}  // namespace

// entries: n rows of six int64 (cost, n_valid, out: device pointers; B, Q, M)
// of contiguous cost [B, Q, M] float32, n_valid [B] int64 and out [B, M] int64
// on the current device. Bytes of device memory that jv_assign needs as its
// workspace for them: 0 when every matrix's A and vectors fit in shared
// memory; -1 for invalid entries, or a CUDA error, negated.
extern "C" int64_t jv_assign_workspace_bytes(const int64_t* entries, int n) {
  if (!entries_valid(entries, n)) return -1;
  int max_dynamic = 0;
  const int err = limits_of_current_device(&max_dynamic);
  if (err != 0) return negated(err);
  int64_t total = 0;
  for (int e = 0; e < n; ++e) {
    const int64_t* row = entries + 6 * e;
    if (row[5] == 0) continue;
    const Plan plan = plan_of(static_cast<int>(row[4]), static_cast<int>(row[5]), max_dynamic);
    total += row[3] * plan.workspace_bytes;
  }
  return total;
}

// Solves every matrix of the entries (each batch element of each entry), in
// one launch when they are at most kMaxMatrices = 64 (a launch more for each
// 64 more): a warp for a matrix of at most kWarpMaxCols solved columns, a
// block of kBlockThreads threads for a wider one. workspace:
// jv_assign_workspace_bytes(entries, n) bytes of device memory (null when
// that is 0). Returns the number of launches (>= 0), -1 when the entries are
// invalid or the workspace is too small, or the CUDA error of a launch,
// negated.
extern "C" int jv_assign(const int64_t* entries, int n, void* workspace, int64_t workspace_bytes,
                         void* stream) {
  if (!entries_valid(entries, n)) return -1;
  int max_dynamic = 0;
  int err = limits_of_current_device(&max_dynamic);
  if (err != 0) return negated(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  int64_t ws_used = 0;
  int launches = 0;

  // the matrices of one launch: block ones from the front, warp ones from the back
  Table table;
  Matrix warps[kMaxMatrices];
  int n_block = 0, n_warp = 0;
  int64_t block_shared = 0;
  auto flush = [&]() -> int {
    if (n_block + n_warp == 0) return 0;
    for (int w = 0; w < n_warp; ++w) table.m[n_block + w] = warps[w];
    const int e = launch(table, n_block, n_block + n_warp, block_shared, s);
    n_block = n_warp = 0;
    block_shared = 0;
    if (e != 0) return e;
    ++launches;
    return 0;
  };

  for (int e = 0; e < n; ++e) {
    const int64_t* row = entries + 6 * e;
    const int64_t B = row[3];
    const int Q = static_cast<int>(row[4]), M = static_cast<int>(row[5]);
    if (M == 0) continue;
    const Plan plan = plan_of(Q, M, max_dynamic);
    for (int64_t b = 0; b < B; ++b) {
      Matrix m;
      m.cost = reinterpret_cast<const float*>(row[0]) + b * Q * M;
      m.n_valid = reinterpret_cast<const int64_t*>(row[1]) + b;
      m.out = reinterpret_cast<int64_t*>(row[2]) + b * M;
      m.ws = nullptr;
      m.Q = Q;
      m.M = M;
      m.flags = plan.flags;
      m.pad = 0;
      if (plan.workspace_bytes) {
        if (ws == nullptr || ws_used + plan.workspace_bytes > workspace_bytes) return -1;
        m.ws = ws + ws_used;
        ws_used += plan.workspace_bytes;
      }
      if (plan.warp) {
        warps[n_warp++] = m;
      } else {
        table.m[n_block++] = m;
        if (plan.shared_bytes > block_shared) block_shared = plan.shared_bytes;
      }
      if (n_block + n_warp == kMaxMatrices && (err = flush()) != 0) return negated(err);
    }
  }
  if ((err = flush()) != 0) return negated(err);
  return launches;
}
