// Fugue-tree linearization of a bucket's rows (the device plan's resolve).
// For each row of the int32 columns cols [7, b, n], in this order
//   parent, side, key_pos, key_agent, key_seq, new_vis, old_vis
// (parent == n is the virtual root; padding nodes carry parent n, side 1,
// INT32_MAX keys and zero visibility), write [b, n] int32
//   perm[r]   = the r-th node in document order
//   nv_doc[r] = new_vis[perm[r]],  ov_doc[r] = old_vis[perm[r]]
// which is gpu/linearize.py::fugue_linearize followed by the two gathers
// that feed K2, on every row that is a Fugue tree with sides 0 and 1 (every
// input the transform builds).
//
// Replaces no TPU kernel: the JAX package runs fugue_linearize_jax as XLA
// ops (tpu/linearize.py), and the port ran it as a chain of about 150
// PyTorch calls a resolve (five stable sorts with their gathers, then
// pointer jumping in about 11 rounds of 7 ops). Each call leaves the
// interpreter and has to win the GIL back from the serve tier's other
// threads, so beside the flush workers the chain cost far more on the host
// than on the card. This kernel is the whole chain in one launch.
//
// Design: one block per row, the row in shared memory (past kMaxN nodes,
// in global scratch: see below).
//   1. Load: grp = parent * 2 + side and the three keys; idx[i] = i, padded
//      to a power of two P with indices >= n, which order after every node.
//   2. Sibling order: a block-wide bitonic sort of idx by (grp, key_pos,
//      key_agent, key_seq, index). The index as the last key makes the
//      order strict, so it is exactly the plain version's chain of stable
//      sorts (np.lexsort order).
//   3. Tour: the successor of each of the 3N cells of the threaded Euler
//      tour, N = n + 1 (the root is node n): pre(x) = x goes to its first
//      left child's pre, else to visit(x) = N + x; visit(x) goes to its
//      first right child's pre, else to post(x) = 2N + x; post(x) goes to
//      its next sibling's pre, else to visit(parent) for a left child and
//      post(parent) for a right one; the root's post ends the tour. A sorted
//      position whose left neighbour has another grp is a group head, and
//      heads overwrite their parent's pre or visit successor after a
//      barrier (no two heads share a cell).
//   4. Ranking: weighted list ranking by pointer jumping, weight 1 on the
//      visit cells of the n nodes and 0 elsewhere. In a round every thread
//      reads its cells' successor and weight sum into registers and writes
//      them after a barrier, so a round reads only the previous round's
//      values; ceil(log2(3N)) rounds reach the end from every cell. A visit
//      cell's sum is then the number of nodes at or after it, so node x
//      lands at r = n - sum. The ranks are distinct, so this scatter is the
//      plain version's stable argsort of the visit ranks.
//   5. perm[r] = x, and the gathers read new_vis[x] and old_vis[x] from the
//      columns in device memory.
//
// Where the row lives: rows up to kMaxN (4,096) nodes in shared memory,
// 4 bytes x (4n + P + 6(n + 1)), 180,248 bytes at n 4,096 (opted in above
// 48 KB per launch, as zone_tape.cu does), with P clamped to [32, 1024]
// threads, so a thread holds at most kMaxCells tour cells in registers
// during a jumping round. A wider row runs the same phases on 1,024
// threads in a global scratch area the caller passes, one slice a row of
// dt_linearize_scratch_words(n): the keys and sort slots, and the tour's
// cells twice over, since its rounds read one copy and write the other.
//
// What bounds it on an H100: neither bytes nor operations. A row of n 256
// reads 7 KB and writes 3 KB (about 3 ns at 3.35 TB/s); its work is
// P log2(P)^2 / 4 compare-exchanges and 3N ceil(log2(3N)) jumps in shared
// memory. The launch and the block's barriers (log2(P)(log2(P) + 1) / 2
// sort stages, two a jumping round) set the time, and the rows run in
// parallel, one block each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 4096;        // the widest row in shared memory
constexpr int kMaxWideN = 1 << 26; // the widest row: its cells fit an int
constexpr int kMaxThreads = 1024;
constexpr int kMaxCells = 13;  // ceil(3 (kMaxN + 1) / kMaxThreads)

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

long long smem_words(int n) {
  return 4LL * n + pow2_at_least(n) + 6LL * (n + 1);
}

// Strict order of sort slots a != b: nodes by (grp, key_pos, key_agent,
// key_seq, index); the padding slots (index >= n) after every node.
__device__ __forceinline__ bool before(int a, int b, int n,
                                       const int32_t* grp, const int32_t* kp,
                                       const int32_t* ka, const int32_t* ks) {
  if (a >= n || b >= n) return a < b;
  if (grp[a] != grp[b]) return grp[a] < grp[b];
  if (kp[a] != kp[b]) return kp[a] < kp[b];
  if (ka[a] != ka[b]) return ka[a] < ka[b];
  if (ks[a] != ks[b]) return ks[a] < ks[b];
  return a < b;
}

// Words of one row's global scratch (the wide kernel): 4n keys, P sort
// slots, and two copies of the 3(n + 1) tour cells' successors and sums.
__host__ __device__ long long wide_scratch_words(int n, int P) {
  return 4LL * n + P + 12LL * (n + 1);
}

// kWide: the row in `scratch` (global memory), pointer jumping through
// two copies of the cells; else in shared memory, jumping through
// registers.
template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
linearize_rows_kernel(const int32_t* __restrict__ cols,
                      int32_t* __restrict__ perm,
                      int32_t* __restrict__ nv_doc,
                      int32_t* __restrict__ ov_doc, int32_t* scratch, int b,
                      int n, int P) {
  extern __shared__ int32_t sm[];
  const int N = n + 1, C = 3 * N;
  int32_t* grp =
      kWide ? scratch + (int64_t)blockIdx.x * wide_scratch_words(n, P) : sm;
  int32_t* kp = grp + n;
  int32_t* ka = kp + n;
  int32_t* ks = ka + n;
  int32_t* idx = ks + n;     // P sort slots
  int32_t* succ = idx + P;   // C tour cells
  int32_t* val = succ + C;   // C weight sums
  const int tid = threadIdx.x, T = blockDim.x;
  const int64_t plane = (int64_t)b * n;
  const int64_t row = (int64_t)blockIdx.x * n;
  const int32_t* in = cols + row;  // column k of this row at in + k * plane

  // 1. load
  for (int i = tid; i < n; i += T) {
    grp[i] = in[i] * 2 + in[plane + i];
    kp[i] = in[2 * plane + i];
    ka[i] = in[3 * plane + i];
    ks[i] = in[4 * plane + i];
  }
  for (int i = tid; i < P; i += T) idx[i] = i;
  __syncthreads();

  // 2. sibling order: bitonic sort, ascending at the last merge
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < (P >> 1); t += T) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        const int a = idx[lo], c = idx[hi];
        if (before(c, a, n, grp, kp, ka, ks) == ((lo & k) == 0)) {
          idx[lo] = c;
          idx[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // 3. tour: defaults and post cells, then the group heads
  for (int v = tid; v < N; v += T) {
    succ[v] = N + v;
    val[v] = 0;
    succ[N + v] = 2 * N + v;
    val[N + v] = v < n;
    val[2 * N + v] = 0;
  }
  for (int j = tid; j < n; j += T) {
    const int x = idx[j], g = grp[x], p = g >> 1;
    const int nx = j + 1 < n ? idx[j + 1] : -1;
    succ[2 * N + x] = nx >= 0 && grp[nx] == g ? nx
                      : (g & 1) ? 2 * N + p
                                : N + p;
  }
  if (tid == 0) succ[2 * N + n] = -1;
  __syncthreads();
  for (int j = tid; j < n; j += T) {
    const int x = idx[j], g = grp[x], p = g >> 1;
    if ((j == 0 || grp[idx[j - 1]] != g) && p >= 0 && p <= n)
      succ[(g & 1) ? N + p : p] = x;
  }
  __syncthreads();

  // 4. ranking: pointer jumping, one round's reads before its writes
  const int rounds = 32 - __clz(C - 1);
  if constexpr (kWide) {
    int32_t* succ2 = val + C;
    int32_t* val2 = succ2 + C;
    for (int r = 0; r < rounds; ++r) {
      for (int c = tid; c < C; c += T) {
        const int s = succ[c];
        const bool live = s >= 0 && s < C;
        succ2[c] = live ? succ[s] : -1;
        val2[c] = live ? val[c] + val[s] : val[c];
      }
      __syncthreads();
      int32_t* t = succ;
      succ = succ2;
      succ2 = t;
      t = val;
      val = val2;
      val2 = t;
    }
  } else {
    for (int r = 0; r < rounds; ++r) {
      int ns[kMaxCells], nw[kMaxCells];
#pragma unroll
      for (int e = 0; e < kMaxCells; ++e) {
        const int c = tid + e * T;
        if (c < C) {
          const int s = succ[c];
          const bool live = s >= 0 && s < C;
          ns[e] = live ? succ[s] : -1;
          nw[e] = live ? val[c] + val[s] : val[c];
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kMaxCells; ++e) {
        const int c = tid + e * T;
        if (c < C) {
          succ[c] = ns[e];
          val[c] = nw[e];
        }
      }
      __syncthreads();
    }
  }

  // 5. the order and the doc-order visibility columns
  const int32_t* nv_in = in + 5 * plane;
  const int32_t* ov_in = in + 6 * plane;
  for (int x = tid; x < n; x += T) {
    const int r = n - val[N + x];
    if (r >= 0 && r < n) {
      perm[row + r] = x;
      nv_doc[row + r] = nv_in[x];
      ov_doc[row + r] = ov_in[x];
    }
  }
}

}  // namespace

extern "C" {

// The widest row the kernel holds in shared memory.
int dt_linearize_max_n() { return kMaxN; }

// Dynamic shared memory a block takes for rows of n <= kMaxN nodes.
long long dt_linearize_smem_bytes(int n) { return 4 * smem_words(n); }

// Words of global scratch a row of n nodes takes: 0 up to kMaxN, else
// the wide kernel's slice.
long long dt_linearize_scratch_words(int n) {
  return n <= kMaxN ? 0 : wide_scratch_words(n, pow2_at_least(n));
}

// Launch on `stream` (b >= 1, 1 <= n <= kMaxWideN): one block per row over
// the [7, b, n] columns at `cols`, writing perm, nv_doc and ov_doc, each
// [b, n]. Rows wider than kMaxN need `scratch`: b slices of
// dt_linearize_scratch_words(n) int32 words, which the kernel overwrites.
// Returns the first CUDA error of the set-up or the launch.
int dt_linearize_rows(const void* cols, void* perm, void* nv_doc,
                      void* ov_doc, void* scratch, int b, int n,
                      void* stream) {
  if (b < 1 || n < 1 || n > kMaxWideN || (n > kMaxN && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = pow2_at_least(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(cols);
  int32_t* pm = static_cast<int32_t*>(perm);
  int32_t* nv = static_cast<int32_t*>(nv_doc);
  int32_t* ov = static_cast<int32_t*>(ov_doc);
  if (n > kMaxN) {
    linearize_rows_kernel<true><<<b, kMaxThreads, 0, s>>>(
        c, pm, nv, ov, static_cast<int32_t*>(scratch), b, n, P);
    return static_cast<int>(cudaGetLastError());
  }
  const int T = P < 32 ? 32 : (P > kMaxThreads ? kMaxThreads : P);
  if (3LL * (n + 1) > (long long)kMaxCells * T)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 4 * (size_t)smem_words(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)linearize_rows_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  linearize_rows_kernel<false><<<b, T, smem, s>>>(c, pm, nv, ov, nullptr, b,
                                                  n, P);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
