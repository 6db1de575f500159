// Kernel J1: exact linear sum assignment of a batch of cost matrices, one
// thread block per matrix (Jonker-Volgenant shortest augmenting paths).
//
// Replaces the JAX package's on-device solve, tair_tpu/spotter/matcher.py::
// _jv_single (:86-177) and jv_assignment (:180-211): lax while loops that XLA
// compiles, no Pallas kernel. Its plain version is
// tair_tpu_torch/spotter/matcher.py::jv_assignment_reference; this kernel
// computes the same float32 values in the same order and takes the same
// first-index argmin, so the assignment equals both bit for bit, ties included.
//
// What bounds it on the H100: neither bytes nor operations. A matrix of the
// training step is 100 x 8 to 100 x 32 floats (3-13 KB); the solve is a chain
// of dependent Dijkstra steps (one per column that joins the tree), each a
// relaxation of the remaining columns, a block-wide argmin and one barrier.
// So it is latency-bound: the design keeps everything in shared memory, spends
// one __syncthreads per step (the argmin's partials are double-buffered), and
// makes the whole solve one launch that reads nothing back to the host, so a
// training step's seven matchings cost seven launches and no host sync, and
// can be captured in a CUDA graph.
//
// Layout. cost [B, Q, M] float32 (queries x target slots), n_valid [B] int64,
// out [B, M] int64 (query per target, -1 for padded or unmatched targets).
// With M <= Q the matrix is solved target-major: row r < M is target r, column
// c < Q is query c, A[r][c] = cost[c][r] for r < n_valid and 0 for padded rows.
// With M > Q it is solved query-major: row r < Q is query r, column c < M is
// target c, A[r][c] = cost[r][c] for c < n_valid and 1e6 for padded columns;
// the result is read back through row4col (the inverse assignment). Rows <=
// columns either way, so every row's search reaches a free column within
// `cols` steps; both loops are bounded, so no input (NaN included) hangs the
// card. A is staged in shared memory when it fits beside the vectors (up to
// the opt-in maximum), else read from device memory through the same map.
// The vectors (five a column, three a row) live in shared memory when they
// fit (up to about 13,600 columns: the encoder's box matching at 512 x 512
// has 9472), else in a workspace in device memory that the wrapper allocates
// (jv_assign_workspace_bytes says how much), read through L1 and L2.
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
constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float solved_entry(const float* __restrict__ cost, int r, int c,
                                              int M, bool target_major, int64_t nv) {
  if (target_major) return r < nv ? cost[static_cast<int64_t>(c) * M + r] : 0.0f;
  return c >= nv ? kPad : cost[static_cast<int64_t>(r) * M + c];
}

// (value, index) lexicographic minimum: the first index among equal values,
// as the plain version's argmin takes it
__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    jv_assign_kernel(const float* __restrict__ cost, const int64_t* __restrict__ n_valid,
                     int64_t* __restrict__ out, unsigned char* workspace,
                     int64_t workspace_stride, int Q, int M, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = (nt + 31) >> 5;
  const bool target_major = M <= Q;
  const int R = target_major ? M : Q;  // rows: each gets a column
  const int C = target_major ? Q : M;  // columns
  const int64_t nv = n_valid[blockIdx.x];
  const float* __restrict__ cb = cost + static_cast<int64_t>(blockIdx.x) * Q * M;

  float* sA = reinterpret_cast<float*>(smem);
  // each column's and row's state: in shared memory, after A when A is staged,
  // or this block's part of the workspace
  float* v = workspace ? reinterpret_cast<float*>(workspace + blockIdx.x * workspace_stride)
                       : sA + (staged ? static_cast<int64_t>(R) * C : 0);
  float* spc = v + C;  // shortest path cost to each column in this row's search
  float* u = spc + C;
  int* row4col = reinterpret_cast<int*>(u + R);
  int* path = row4col + C;
  int* col4row = path + C;
  unsigned char* sc = reinterpret_cast<unsigned char*>(col4row + R);  // column in the tree
  unsigned char* sr = sc + C;                                         // row in the tree

  for (int c = tid; c < C; c += nt) {
    v[c] = 0.0f;
    spc[c] = kInf;
    row4col[c] = -1;
    path[c] = -1;
    sc[c] = 0;
  }
  for (int r = tid; r < R; r += nt) {
    u[r] = 0.0f;
    col4row[r] = -1;
    sr[r] = 0;
  }
  if (staged) {
    // read cost in its own order (coalesced), store it as the solved matrix
    for (int e = tid; e < Q * M; e += nt) {
      const int qi = e / M, mi = e - qi * M;
      const int r = target_major ? mi : qi, c = target_major ? qi : mi;
      sA[static_cast<int64_t>(r) * C + c] = solved_entry(cb, r, c, M, target_major, nv);
    }
  }
  __syncthreads();

  int parity = 0;
  for (int cur = 0; cur < R; ++cur) {
    // --- Dijkstra from row cur until a free column is reached ---
    int i = cur, sink = -1;
    float min_val = 0.0f;
    for (int step = 0; step < C; ++step) {
      if (tid == 0) sr[i] = 1;
      const float ui = u[i];
      float best_v = __int_as_float(0x7f800000);  // above every candidate
      int best_i = 0x7fffffff;
      for (int c = tid; c < C; c += nt) {
        float cand = kInf;  // a column in the tree is masked to kInf
        if (!sc[c]) {
          const float a = staged ? sA[static_cast<int64_t>(i) * C + c]
                                 : solved_entry(cb, i, c, M, target_major, nv);
          const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, a), ui), v[c]);
          if (r < spc[c]) {
            spc[c] = r;
            path[c] = i;
          }
          cand = spc[c];
        }
        take_min(best_v, best_i, cand, c);
      }
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        take_min(best_v, best_i, ov, oi);
      }
      if (lane == 0) {
        red_v[parity][warp] = best_v;
        red_i[parity][warp] = best_i;
      }
      __syncthreads();
      best_v = red_v[parity][0];
      best_i = red_i[parity][0];
      for (int w = 1; w < n_warps; ++w) take_min(best_v, best_i, red_v[parity][w], red_i[parity][w]);
      parity ^= 1;  // the next step writes the other buffer: one barrier a step
      const int j = best_i;
      min_val = best_v;
      if (j % nt == tid) sc[j] = 1;  // sc[c] is read only by the thread of column c
      const int owner = row4col[j];
      if (owner < 0) {
        sink = j;
        break;
      }
      i = owner;
    }

    // --- dual update (scipy _lsap convention) ---
    for (int r = tid; r < R; r += nt) {
      if (r == cur) {
        u[r] = __fadd_rn(u[r], min_val);
      } else if (sr[r]) {
        const int c = col4row[r] < 0 ? 0 : col4row[r];
        u[r] = __fadd_rn(u[r], __fsub_rn(min_val, spc[c]));
      }
      sr[r] = 0;
    }
    for (int c = tid; c < C; c += nt) {
      if (sc[c]) v[c] = __fsub_rn(v[c], __fsub_rn(min_val, spc[c]));
    }
    __syncthreads();  // the dual update has read spc and col4row

    // --- augment along the alternating path back to row cur ---
    if (tid == 0 && sink >= 0) {
      int j = sink;
      for (int k = 0; k < R; ++k) {
        const int pi = path[j];
        if (pi < 0) break;
        row4col[j] = pi;
        const int next = col4row[pi];
        col4row[pi] = j;
        if (pi == cur || next < 0) break;
        j = next;
      }
    }
    for (int c = tid; c < C; c += nt) {  // path needs no reset: it is read only in the tree
      sc[c] = 0;
      spc[c] = kInf;
    }
    __syncthreads();
  }

  int64_t* ob = out + static_cast<int64_t>(blockIdx.x) * M;
  for (int t = tid; t < M; t += nt) {
    const int q = target_major ? col4row[t] : row4col[t];
    ob[t] = t < nv ? q : -1;
  }
}

struct Limits {
  bool known = false;
  int max_dynamic = 0;  // bytes of dynamic shared memory a block may take
};

// The launch's plan: whether A is staged, whether the vectors sit in shared
// memory, the dynamic shared memory and the workspace a block needs.
struct Plan {
  int staged = 0;
  int64_t shared_bytes = 0;
  int64_t workspace_stride = 0;  // 0: the vectors are in shared memory
};

int limits_of_current_device(int* max_dynamic) {
  static Limits limits[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  Limits& lim = limits[dev];
  if (!lim.known) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, jv_assign_kernel);
    if (err != cudaSuccess) return err;
    lim.max_dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(jv_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lim.max_dynamic);
    if (err != cudaSuccess) return err;
    lim.known = true;
  }
  *max_dynamic = lim.max_dynamic;
  return 0;
}

Plan plan_of(int Q, int M, int max_dynamic) {
  const bool target_major = M <= Q;
  const int64_t R = target_major ? M : Q, C = target_major ? Q : M;
  // v spc row4col path sc a column; u col4row sr a row
  const int64_t vectors = C * (4 + 4 + 4 + 4 + 1) + R * (4 + 4 + 1);
  const int64_t matrix = R * C * 4;
  Plan plan;
  if (matrix + vectors <= max_dynamic) {
    plan.staged = 1;
    plan.shared_bytes = matrix + vectors;
  } else if (vectors <= max_dynamic) {
    plan.shared_bytes = vectors;
  } else {
    plan.workspace_stride = (vectors + 15) / 16 * 16;
  }
  return plan;
}

}  // namespace

// Bytes of device memory the wrapper must hand jv_assign as its workspace for
// a [B, Q, M] batch on the current device: 0 when each matrix's vectors fit
// in shared memory; -1 (or a CUDA error, negated) when the device cannot be read.
extern "C" int64_t jv_assign_workspace_bytes(int B, int Q, int M) {
  int max_dynamic = 0;
  const int err = limits_of_current_device(&max_dynamic);
  if (err != 0) return err > 0 ? -static_cast<int64_t>(err) : -1;
  return static_cast<int64_t>(B < 0 ? 0 : B) * plan_of(Q, M, max_dynamic).workspace_stride;
}

// cost [B, Q, M] float32, n_valid [B] int64, out [B, M] int64, all contiguous on
// the current device; workspace: jv_assign_workspace_bytes(B, Q, M) bytes of
// device memory (null when that is 0). Returns 0, -1 when the workspace given
// is too small or the shape is invalid, or the CUDA error of the launch.
extern "C" int jv_assign(const float* cost, const int64_t* n_valid, int64_t* out,
                         void* workspace, int64_t workspace_bytes, int B, int Q, int M,
                         void* stream) {
  if (B < 0 || Q < 0 || M < 0) return -1;
  if (B == 0 || M == 0) return 0;
  int max_dynamic = 0;
  const int err = limits_of_current_device(&max_dynamic);
  if (err != 0) return err;
  const Plan plan = plan_of(Q, M, max_dynamic);
  if (plan.workspace_stride && (workspace == nullptr ||
                                workspace_bytes < plan.workspace_stride * B)) {
    return -1;
  }
  const int64_t C = M <= Q ? Q : M;
  const int64_t threads = ((C + 31) / 32) * 32;
  jv_assign_kernel<<<B, static_cast<int>(threads < kMaxThreads ? threads : kMaxThreads),
                     static_cast<size_t>(plan.shared_bytes), static_cast<cudaStream_t>(stream)>>>(
      cost, n_valid, out,
      plan.workspace_stride ? static_cast<unsigned char*>(workspace) : nullptr,
      plan.workspace_stride, Q, M, plan.staged);
  return cudaGetLastError();
}
