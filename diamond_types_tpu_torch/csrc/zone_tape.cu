// The zone engine's step tape (X8) for B independent replicas, in ONE
// launch: the whole scan of the JAX package's zone executor.
//
// Replaces diamond_types_tpu/tpu/zone_kernel.py:480 make_zone_step, run by
// `_run_zone` / `_run_zone_slice` (zone_kernel.py:675-682, :751-758) as an
// XLA `lax.scan` (no `pallas_call`): every step is some 80-100 tensor
// operations over [W] slot planes and [MB, W] block masks, and the steps are
// strictly serial (each reads the rank and order the previous one wrote).
// Here it is one launch per tape (or per slice of a tape), the carry updated
// in place so that a session continues it.
//
// Tape (shared by every replica), all int32: op, a, b, snap [T]; blk_cursor,
// blk_prev, blk_root, blk_start, blk_len [T, MB]; ch_slot, ch_ol_static,
// ch_ol_coord, ch_orr_own, ch_blk, ch_agent, ch_seq [T, MC]; del_kind,
// del_a, del_b [T, MD]. Carry (per replica): state [B, n_idx, W] u8, snap
// and ever [B, W] u8, rank, ord, ol_id, orr_id, agent_k, seq_k [B, W] i32,
// m [B] i32. Scratch (per replica, from the wrapper, global form only): cum
// [B, W] i32, sr [B, W] u8, ord2 [B, W] i32, sr2 [B, W] u8. BIG = 1 << 30
// marks an unplaced rank.
//
// Design: a thread-block cluster of c blocks (c in 1, 2, 4, 8, 16; 1,024
// threads each) per replica, grid B * c. Block j owns the slots [j*S,
// (j+1)*S), S = ceil(W / c), of the slot-indexed planes (state rows, snap,
// ever, rank, ol_id, orr_id, agent_k, seq_k), and the ranks [j*Sr,
// (j+1)*Sr), Sr = ceil(m / c), of the rank-indexed ones (ord, cum, sr and
// the second buffers ord2, sr2): cut by the placed ranks, so all blocks
// share the passes over [0, m) while m is small. In the shared-memory form
// (kSmem) each block loads its slices once (cp.async for the int32
// planes), keeps them in shared memory for the whole tape and writes them
// back once at the end, so a session still continues its carry in place;
// (n_idx + 36) * S bytes a block, S padded to 16. Another block's slices
// are reached through distributed shared memory (generic addresses built
// from each block's `map_shared_rank` base). Where the slices do not fit
// (past 87,296 slots at n_idx 6 and c 16) the global-memory form keeps the
// planes in global memory, with the same slicing and the same phases: one
// template parameter, one algorithm.
//
// What bounds it on an H100 (132 SMs, 227 KB of shared memory a block): the
// serial chain. A replica's steps cannot overlap, so its time is the sum of
// its steps' latencies, and a cluster barrier costs several times a block
// barrier. The design before this one (one block per replica, the carry in
// global memory) made about ten passes over all m ranks a step from ONE SM
// through L2. Here a pass covers m / c ranks, from shared memory, on c SMs;
// the carry crosses L2 twice a launch; an APPLY step has three cluster
// barriers (two when its snapshot did not change), and nothing is
// scattered at random across the cluster but the snapshot states of a
// fresh snapshot:
//   1. the step's tape, loaded into registers during the step before (a
//      global load after a cluster barrier misses L1, whose lines the
//      barrier's acquire drops); the key planes of its chars (by the block
//      owning the slot); the snapshot copy of the row on an entry's first
//      sub-step. Where the snapshot changed (and on a launch's first
//      APPLY: sr is scratch), sr[rank[s]] = snap[s] for every own placed
//      slot (rank[ord[i]] == i on [0, m), so this is the JAX step's gather
//      snap[ord[i]]), the visible ones counted per rank slice and the
//      counts sent to every block;                             [sync A]
//      else sr and its counts were carried by the last step's shift.
//   2. every block's slice totals from the counts; the block's scan of its
//      own ranks into cum (counted within the block: its ranks hold the
//      visible coordinates (below, upto]); then the block holding a
//      coordinate finds its rank by a binary search in its own shared
//      memory, for the cursors of the step's blocks (sent to every block)
//      and for the origins of chars placed by coordinate (written into the
//      char's slot, from the OLD order), as the JAX step's searchsorted
//      over cum does;                                          [sync C]
//   3. warp k of every block resolves block k of the step alike (so the
//      result needs no exchange): a = the cursor's rank or, for a
//      continuation, the rank of the previous chunk's last char; b = the
//      first non-NotInsertedYet rank after a (a ballot scan); then the
//      YjsMod integrate over the ranks between a and b alone (the first
//      break, the last reset before it, the first set after that reset),
//      its reads of ord, sr, ol_id, orr_id, rank and the keys remote where
//      the window crosses slices;                        [block barrier]
//   4. the next order and sr: each own placed rank i shifted to i + bump(i)
//      in the second buffers (neighbouring lanes write neighbouring ranks,
//      mostly in one block; together with the new chars a permutation of
//      [0, m'): no atomics), the visible ones counted per rank slice of
//      the next step and the counts sent to every block; the new chars'
//      metadata by the owner of their slot; deletes by coordinate over the
//      block's own ranks, writing state and ever in the deleted slots'
//      blocks. No rank is written: other blocks may still be integrating
//      over the old ranks;                                     [sync E]
//   5. deletes by own slot range; the own slots' rank bump (slot by slot,
//      local), then the new chars' ranks; the buffers swap; m = m'.
// After the last step the order goes back to the carry with its tail [m,
// W) zero, as the JAX step's fresh order scatter leaves it (untouched where
// no APPLY step ran). Every block reaches a final cluster barrier before
// it exits: the shared memory of an exited block is undefined for the
// others. Writes aimed out of range (pad chars at W) are skipped; every
// clamped JAX gather is an explicit clamp plus its fill. The reductions
// are over integer indices, so the result is bit-identical to the plain
// version and the JAX scan on all ten carry planes, at every c and in both
// forms. The wrapper's `cluster_size(B, W, n_idx)` picks c and the form
// (gpu/kernels.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
// elements a thread loads before it works on them, in the long passes
constexpr int kUnroll = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 32;       // MB: at most one warp per block
constexpr int kMaxCluster = 16;
// the cursor ranks' publication takes one thread a (block, cluster rank)
static_assert(kThreads >= kMaxBlocks * kMaxCluster, "too few threads");
constexpr int32_t kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
// the dynamic shared memory a block may take: the card's 232,448 bytes a
// block less 3,072 for the kernel's static arrays (gpu/kernels.py mirrors)
constexpr long long kSmemBudget = 232448 - 3072;

struct Tape {
  const int32_t *op, *a, *b, *snap;
  const int32_t *blk_cursor, *blk_prev, *blk_root, *blk_start, *blk_len;
  const int32_t *ch_slot, *ch_ol_static, *ch_ol_coord, *ch_orr_own, *ch_blk,
      *ch_agent, *ch_seq;
  const int32_t *del_kind, *del_a, *del_b;
};

struct Carry {
  uint8_t* state;
  uint8_t* snap;
  int32_t* rank;
  int32_t* ord;
  int32_t* ol_id;
  int32_t* orr_id;
  uint8_t* ever;
  int32_t* m;
  int32_t* agent_k;
  int32_t* seq_k;
  int32_t* cum;   // scratch (global form)
  uint8_t* sr;    // scratch (global form)
  int32_t* ord2;  // scratch (global form)
  uint8_t* sr2;   // scratch (global form)
};

// Slice padded to 16 bytes; the shared-memory form's bytes a block.
__host__ __device__ __forceinline__ long long slice_pad(int W, int c) {
  const long long S = (W + c - 1) / c;
  return (S + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ long long smem_bytes(int W, int n_idx,
                                                         int c) {
  return (36LL + n_idx) * slice_pad(W, c);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst_smem, const void* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 state bytes of OP_BEGIN from slot w0 on: 1 below plen, else 0.
__device__ __forceinline__ uint4 begin_bytes(int w0, int plen) {
  unsigned v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x |= (w0 + 4 * q + b < plen ? 1u : 0u) << (8 * b);
    v[q] = x;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint4 max_bytes(uint4 x, uint4 y) {
  return make_uint4(__vmaxu4(x.x, y.x), __vmaxu4(x.y, y.y),
                    __vmaxu4(x.z, y.z), __vmaxu4(x.w, y.w));
}

// Where element `idx` (a slot or a rank, 0 <= idx < W) of a plane lives.
// A plane is named by its handle in THIS block: in the shared-memory form
// the block's own slice (every block lays its slices out alike, so block
// k's copy sits at the handle's offset from k's shared-memory base, a
// generic address from `map_shared_rank`: built from that base, not from
// the handle, so the compiler emits generic loads that reach other blocks
// and never shared-window loads that would not); in the global form the
// replica's whole row.
template <bool kSmem>
struct View {
  int S;                    // slice length
  int off;                  // handle index of the block's first element
  char* const* base;        // per cluster rank (shared-memory form)
  const unsigned char* own_base;   // this block's dynamic shared memory

  template <typename T>
  __device__ __forceinline__ T* at(T* p, int idx) const {
    if constexpr (kSmem) {
      const int k = idx / S;
      const size_t o = (const unsigned char*)p - own_base;
      // (a C cast: T may be const)
      return (T*)(base[k] + o) + (idx - k * S);
    } else {
      return p + idx;
    }
  }
  // an element of the block's own slice, by its global index
  template <typename T>
  __device__ __forceinline__ T* own(T* p, int idx) const {
    return p + (idx - off);
  }
};

// Count `bin` (>= 0; -1 counts nothing) into the block's bins, the lanes
// of a warp with one bin added at once. Every lane of the warp calls it.
__device__ __forceinline__ void count_bin(int* bins, int bin, int lane) {
  const unsigned mask = __ballot_sync(kFull, bin >= 0);
  if (bin >= 0) {
    const unsigned peers = __match_any_sync(mask, bin);
    if (lane == __ffs((int)peers) - 1) atomicAdd(&bins[bin], __popc(peers));
  }
}

// Block j's bins into row j of every cluster block's table, one remote
// store a thread. After a block barrier; ordered for the readers by a
// cluster barrier; the bins are zeroed by the caller a barrier later.
__device__ __forceinline__ void publish_bins(const cg::cluster_group& cl,
                                             const int* bins,
                                             int (*tab)[kMaxCluster], int j,
                                             int c, int tid) {
  if (tid < c * c) {
    const int q = tid / c, k = tid - q * c;
    *cl.map_shared_rank(&tab[j][k], q) = bins[k];
  }
}

// One char of a step's tape row, and the step's scalars, its block row
// (for thread k < MB), its first char (thread k) and its first delete
// (warp k): what a thread reads of step t, loaded into registers during
// the step before, after its last cluster barrier. Global loads after a
// cluster barrier miss L1 (its acquire drops L1's lines), so a load at
// the point of use would cost each phase a trip to L2.
struct Ch {
  int slot, blk, ol_static, ol_coord, orr_own, agent, seq;
};

__device__ __forceinline__ Ch load_ch(const Tape& tp, size_t tc, int k) {
  return Ch{tp.ch_slot[tc + k],     tp.ch_blk[tc + k],
            tp.ch_ol_static[tc + k], tp.ch_ol_coord[tc + k],
            tp.ch_orr_own[tc + k],  tp.ch_agent[tc + k],
            tp.ch_seq[tc + k]};
}

struct Del {
  int kind, a, b;
};

__device__ __forceinline__ Del load_del(const Tape& tp, size_t td, int k) {
  return Del{tp.del_kind[td + k], tp.del_a[td + k], tp.del_b[td + k]};
}

struct Step {
  int op, a, b, snap;
  int cursor, prev, root, start, len;   // block `tid` (tid < MB)
  Ch ch;                                // char `tid` (tid < MC)
  Del del;                              // delete `warp` (warp < MD)
};

__device__ __forceinline__ Step load_step(const Tape& tp, int t, int MB,
                                          int MC, int MD, int tid,
                                          int warp) {
  Step x;
  x.op = tp.op[t];
  x.a = tp.a[t];
  x.b = tp.b[t];
  x.snap = tp.snap[t];
  x.cursor = x.prev = x.root = x.start = x.len = 0;
  if (tid < MB) {
    const size_t tb = (size_t)t * MB + tid;
    x.cursor = tp.blk_cursor[tb];
    x.prev = tp.blk_prev[tb];
    x.root = tp.blk_root[tb];
    x.start = tp.blk_start[tb];
    x.len = tp.blk_len[tb];
  }
  x.ch = tid < MC ? load_ch(tp, (size_t)t * MC, tid)
                  : Ch{-1, 0, -1, 0, -1, 0, 0};
  x.del = warp < MD ? load_del(tp, (size_t)t * MD, warp) : Del{-1, 0, 0};
  return x;
}

// First i in [lo, hi) with cum[i] >= v, or hi, by one thread over the
// block's own ranks (local reads).
template <bool kSmem>
__device__ __forceinline__ int lower_bound_own(const View<kSmem>& V,
                                               const int32_t* cum, int lo,
                                               int hi, long long v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)*V.own(cum, mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
zone_tape_kernel(Tape tp, Carry g, int T, int W, int plen, int n_idx,
                 int MB, int MC, int MD) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int j = static_cast<int>(cluster.block_rank());
  const size_t r = blockIdx.x / c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = (W + c - 1) / c;
  const int P = static_cast<int>(slice_pad(W, c));
  const int lo = j * S;                       // own slots and ranks
  const int hi = min(lo + S, W);              // [lo, hi), empty past W
  // a cluster barrier (a block barrier where the cluster is one block)
  auto csync = [&]() {
    if (c == 1)
      __syncthreads();
    else
      cluster.sync();
  };

  __shared__ int s_cursor[kMaxBlocks], s_prev[kMaxBlocks],
      s_root[kMaxBlocks], s_start[kMaxBlocks], s_len[kMaxBlocks];
  __shared__ int s_t[kMaxBlocks], s_L[kMaxBlocks], s_orr[kMaxBlocks];
  __shared__ int s_arank[kMaxBlocks];   // block k's cursor rank
  __shared__ int s_cnt[kWarps], s_vis[kWarps], s_woff[kWarps], s_nvalid;
  // s_hist[k]: this block's visible slots whose rank lies in slice k
  // (s_hist4: the same after the shift, for the next step); s_tab[i][k]:
  // block i's bins, written by block i
  __shared__ int s_hist[kMaxCluster], s_hist4[kMaxCluster],
      s_tab[kMaxCluster][kMaxCluster];
  __shared__ int s_incl[kMaxCluster];
  __shared__ char* s_base[kMaxCluster];
  extern __shared__ __align__(16) unsigned char smem[];

  uint8_t* const gstate = g.state + r * (size_t)n_idx * W;
  // ord and sr alternate with ord2 and sr2 from step to step: a step reads
  // the order and the snapshot states in rank order from (ord, sr) and
  // writes the next ones into (ord2, sr2), then the names swap
  int32_t *rank, *ol_id, *orr_id, *agent_k, *seq_k, *ord, *cum, *ord2;
  uint8_t *snap, *ever, *sr, *sr2, *state;
  size_t stride;                              // between state rows
  if constexpr (kSmem) {
    int32_t* w = reinterpret_cast<int32_t*>(smem);
    rank = w;
    ol_id = w + P;
    orr_id = w + 2 * P;
    agent_k = w + 3 * P;
    seq_k = w + 4 * P;
    ord = w + 5 * P;
    cum = w + 6 * P;
    ord2 = w + 7 * P;
    uint8_t* b = smem + 32 * (size_t)P;
    snap = b;
    ever = b + P;
    sr = b + 2 * P;
    sr2 = b + 3 * P;
    state = b + 4 * P;
    stride = P;
  } else {
    rank = g.rank + r * W;
    ol_id = g.ol_id + r * W;
    orr_id = g.orr_id + r * W;
    agent_k = g.agent_k + r * W;
    seq_k = g.seq_k + r * W;
    ord = g.ord + r * W;
    cum = g.cum + r * W;
    ord2 = g.ord2 + r * W;
    snap = g.snap + r * W;
    ever = g.ever + r * W;
    sr = g.sr + r * W;
    sr2 = g.sr2 + r * W;
    state = gstate;
    stride = W;
  }
  const View<kSmem> V{S, kSmem ? lo : 0, s_base, smem};
  // The rank-indexed planes (ord, cum, sr and their second buffers) are
  // cut by the placed ranks instead: block j holds [j * Sr, (j+1) * Sr)
  // with Sr = ceil(m / c), so every block shares the passes over [0, m)
  // however small m is; Sr <= S, so a slice always fits.
  auto rank_view = [&](int mm) {
    const int Sr = max(1, (mm + c - 1) / c);
    return View<kSmem>{Sr, kSmem ? j * Sr : 0, s_base, smem};
  };
  if (tid < kMaxCluster) s_hist[tid] = s_hist4[tid] = 0;

  // ---- the carry's slices into shared memory, once a launch ----
  if constexpr (kSmem) {
    if (tid < c)
      s_base[tid] = static_cast<char*>(
          cluster.map_shared_rank(static_cast<void*>(smem), tid));
    int32_t* const gi[5] = {g.rank, g.ol_id, g.orr_id, g.agent_k, g.seq_k};
    int32_t* const si[5] = {rank, ol_id, orr_id, agent_k, seq_k};
#pragma unroll
    for (int q = 0; q < 5; ++q)
      for (int i = lo + tid; i < hi; i += kThreads)
        cp_async4(V.own(si[q], i), gi[q] + r * W + i);
    {
      const int m0 = g.m[r];
      const View<kSmem> R0 = rank_view(m0);
      for (int i = R0.off + tid; i < min(R0.off + R0.S, m0); i += kThreads)
        cp_async4(R0.own(ord, i), g.ord + r * W + i);
    }
    for (int i = lo + tid; i < hi; i += kThreads) {
      *V.own(snap, i) = g.snap[r * W + i];
      *V.own(ever, i) = g.ever[r * W + i];
    }
    for (int q = 0; q < n_idx; ++q)
      for (int i = lo + tid; i < hi; i += kThreads)
        *V.own(state + q * stride, i) = gstate[(size_t)q * W + i];
    cp_async_wait_all();
  }
  csync();

  int m = g.m[r];
  bool applied = false;     // an APPLY step ran (the order's tail is zero)
  bool sr_valid = false;    // sr[i] == snap[ord[i]] on [0, m)

  Step nxt = load_step(tp, 0, MB, MC, MD, tid, warp);
  for (int t = 0; t < T; ++t) {
    const Step cur = nxt;
    const int op = cur.op;
    if (op != 3) {
      if (t + 1 < T) nxt = load_step(tp, t + 1, MB, MC, MD, tid, warp);
      // ---- row step: BEGIN / FORK / MAX (anything else is MAX) ----
      const int a = clampi(cur.a, 0, n_idx - 1);
      const int tgt = clampi(op == 0 ? cur.a : cur.b, 0, n_idx - 1);
      if constexpr (kSmem) {
        const uint4* src = reinterpret_cast<const uint4*>(state + a * stride);
        uint4* dst = reinterpret_cast<uint4*>(state + tgt * stride);
        for (int q = tid; q < P / 16; q += kThreads) {
          uint4 v;
          if (op == 0)
            v = begin_bytes(lo + 16 * q, plen);
          else if (op == 1)
            v = src[q];
          else
            v = max_bytes(dst[q], src[q]);
          dst[q] = v;
        }
      } else {
        const uint8_t* src = state + a * stride;
        uint8_t* dst = state + tgt * stride;
        for (int w = lo + tid; w < hi; w += kThreads) {
          uint8_t v;
          if (op == 0)
            v = w < plen ? 1 : 0;
          else if (op == 1)
            v = src[w];
          else
            v = max(dst[w], src[w]);
          dst[w] = v;
        }
      }
      __syncthreads();
      continue;
    }

    // ---- APPLY, phase 1: keys, snapshot, blocks, char count; on a fresh
    // step the snapshot states scattered into rank order ----
    const size_t tc = (size_t)t * MC, td = (size_t)t * MD;
    const int row = clampi(cur.a, 0, n_idx - 1);
    const bool snap_now = cur.snap == 1;
    // sr is rebuilt from the slots where the snapshot changes (and on a
    // launch's first APPLY: sr is scratch); else the last step's shift
    // carried it, and its counts per rank slice are in s_tab already
    const bool fresh = snap_now || !sr_valid;
    uint8_t* const st = state + row * stride;
    const View<kSmem> Rk = rank_view(m);
    const int rlo = min(j * Rk.S, m);          // own placed ranks
    const int rhi = min(rlo + Rk.S, m);        // [rlo, rhi)
    const int seg = (rhi - rlo + kWarps - 1) / kWarps;
    const int wlo = min(rlo + warp * seg, rhi), whi = min(wlo + seg, rhi);
    if (tid < MB) {
      s_cursor[tid] = cur.cursor;
      s_prev[tid] = cur.prev;
      s_root[tid] = cur.root;
      s_start[tid] = cur.start;
      s_len[tid] = cur.len;
    }
    int nv = 0;
    for (int k = tid; k < MC; k += kThreads) {
      const Ch ch = k == tid ? cur.ch : load_ch(tp, tc, k);
      if (ch.slot >= 0) {
        ++nv;
        if (ch.slot >= lo && ch.slot < hi) {
          *V.own(agent_k, ch.slot) = ch.agent;
          *V.own(seq_k, ch.slot) = ch.seq;
        }
      }
    }
    nv = warp_sum(nv);
    if (lane == 0) s_cnt[warp] = nv;
    if (snap_now) {
      if constexpr (kSmem) {
        const uint4* src = reinterpret_cast<const uint4*>(st);
        uint4* dst = reinterpret_cast<uint4*>(snap);
        for (int q = tid; q < P / 16; q += kThreads) dst[q] = src[q];
      } else {
        for (int w = lo + tid; w < hi; w += kThreads) snap[w] = st[w];
      }
    }
    if (fresh) {
      // sr[rank[s]] = snap[s] for every own placed slot s (rank[ord[i]]
      // == i on [0, m), so this is the JAX step's gather snap[ord[i]]);
      // the new snapshot is read from the row it copies, so the copy needs
      // no barrier first. Each visible slot is counted into its rank
      // slice's bin, published into every block.
      for (int base = lo; base < hi; base += kUnroll * kThreads) {
        int rs[kUnroll];
        uint8_t v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = base + u * kThreads + tid;
          rs[u] = s < hi ? *V.own(rank, s) : kBig;
          v[u] = s < hi ? (snap_now ? *V.own(st, s) : *V.own(snap, s)) : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          int bin = -1;
          if (rs[u] < m) {
            *Rk.at(sr, rs[u]) = v[u];
            if (v[u] == 1) bin = rs[u] / Rk.S;
          }
          count_bin(s_hist, bin, lane);
        }
      }
      __syncthreads();
      publish_bins(cluster, s_hist, s_tab, j, c, tid);
      csync();                                                 // A
      if (tid < kMaxCluster) s_hist[tid] = 0;
    }

    // ---- phase 2: the slice totals, the own ranks' scan (cum counts
    // the visible ranks within the block: the ranks of the visible
    // coordinates (below, upto] are this block's), the anchors found ----
    {
      int cnt = 0;
      for (int i = wlo + lane; i < whi; i += 32) cnt += *Rk.own(sr, i) == 1;
      cnt = warp_sum(cnt);
      if (lane == 0) s_vis[warp] = cnt;
    }
    __syncthreads();
    if (warp == 0) {
      int v = 0;
      if (lane < c)
        for (int q = 0; q < c; ++q) v += s_tab[q][lane];
      v = warp_incl_scan(v, lane);
      if (lane < c) s_incl[lane] = v;
      const int vis = lane < kWarps ? s_vis[lane] : 0;
      const int vincl = warp_incl_scan(vis, lane);
      if (lane < kWarps) s_woff[lane] = vincl - vis;
      const int nvw = warp_sum(lane < kWarps ? s_cnt[lane] : 0);
      if (lane == 0) s_nvalid = nvw;
    }
    __syncthreads();
    const int nvalid = s_nvalid, total = s_incl[c - 1];
    const int below = j > 0 ? s_incl[j - 1] : 0, upto = s_incl[j];
    {
      int run = s_woff[warp];
      for (int base = wlo; base < whi; base += 32) {
        const int i = base + lane;
        const int v = (i < whi && *Rk.own(sr, i) == 1) ? 1 : 0;
        const int incl = warp_incl_scan(v, lane);
        if (i < whi) *Rk.own(cum, i) = run + incl;
        run += __shfl_sync(kFull, incl, 31);
      }
    }
    // a visible coordinate's rank is found in the one block holding it,
    // by a binary search in its own shared memory: the cursors of the
    // step's blocks (sent to every block) and the origins of chars placed
    // by coordinate (written into the char's slot, with the OLD order),
    // as the JAX step's searchsorted over cum does
    __syncthreads();
    if (tid < MB * c) {
      const int k = tid / c, q = tid - k * c;
      const int cur = s_cursor[k];
      if (s_len[k] > 0 && cur > below && cur <= upto)
        *cluster.map_shared_rank(&s_arank[k], q) =
            lower_bound_own(Rk, cum, rlo, rhi, cur - below);
    }
    for (int k = tid; k < MC; k += kThreads) {
      const Ch ch = k == tid ? cur.ch : load_ch(tp, tc, k);
      if (ch.ol_static != -2 || ch.ol_coord <= below ||
          ch.ol_coord > upto || ch.slot < 0 || ch.slot >= W)
        continue;
      *V.at(ol_id, ch.slot) = *Rk.own(
          ord, lower_bound_own(Rk, cum, rlo, rhi, ch.ol_coord - below));
    }
    csync();                                                   // C

    // ---- phase 3: warp k % (warps) resolves block k, in every block of the
    // cluster alike (so the result needs no exchange and no barrier) ----
    for (int k = warp; k < MB; k += kWarps) {
      const int len = s_len[k];
      int tk = kBig, orr_char = -1;
      if (len > 0) {
        const int cursor = s_cursor[k], prev = s_prev[k], root = s_root[k];
        const bool is_cont = cursor == -2;
        int a_rank;
        if (is_cont)
          a_rank = prev >= 0 ? *V.at(rank, min(prev, W - 1)) : kBig;
        else if (cursor <= 0)
          a_rank = -1;
        else
          a_rank = cursor <= total ? s_arank[k] : W;   // past every rank
        // b0: the first rank after a_rank that is placed and not NIY
        int b0 = W;
        for (long long base = max((long long)a_rank + 1, 0LL); base < m;
             base += 32) {
          const long long i = base + lane;
          const unsigned bal =
              __ballot_sync(kFull, i < m && *Rk.at(sr, (int)i) != 0);
          if (bal) {
            b0 = (int)(base + __ffs((int)bal) - 1);
            break;
          }
        }
        orr_char = b0 < m ? *Rk.at(ord, b0) : -1;
        const int b_rank = min(b0, m);
        if (is_cont) {
          tk = a_rank + 1;
        } else {
          const int agent_c =
              root >= 0 ? *V.at(agent_k, min(root, W - 1)) : 0;
          const int seq_c = root >= 0 ? *V.at(seq_k, min(root, W - 1)) : 0;
          const int b_eff = orr_char < 0 ? kBig : b_rank;
          int jstar = b_rank, streak = -1;
          for (long long base = max((long long)a_rank + 1, 0LL);
               base < b_rank; base += 32) {
            const long long i = base + lane;
            bool brk = false, setv = false, resetv = false;
            if (i < b_rank) {
              const int s = *Rk.at(ord, (int)i);
              const int sc = clampi(s, 0, W - 1);
              const int olw = s >= 0 ? *V.at(ol_id, sc) : -3;
              const int olr =
                  olw == -1 ? -1
                            : (olw >= 0 ? *V.at(rank, min(olw, W - 1)) : kBig);
              const int orw = s >= 0 ? *V.at(orr_id, sc) : -3;
              const int orr_r =
                  orw == -1 ? kBig
                            : (orw >= 0 ? *V.at(rank, min(orw, W - 1)) : kBig);
              const int ag = s >= 0 ? *V.at(agent_k, sc) : 0;
              const int sq = s >= 0 ? *V.at(seq_k, sc) : 0;
              const bool top = olr < a_rank;
              const bool eq = olr == a_rank;
              const bool same = eq && orw == orr_char;
              const bool ins =
                  same && (agent_c < ag || (agent_c == ag && seq_c < sq));
              brk = top || ins;
              setv = eq && !same && orr_r < b_eff;
              resetv = (eq && !same && orr_r >= b_eff) || (same && !ins);
            }
            const unsigned bb = __ballot_sync(kFull, brk);
            const unsigned lim =
                bb ? ((1u << (__ffs((int)bb) - 1)) - 1u) : kFull;
            const unsigned rm = __ballot_sync(kFull, resetv) & lim;
            unsigned sm = __ballot_sync(kFull, setv) & lim;
            if (rm) {
              const int lr = 31 - __clz((int)rm);
              streak = -1;
              sm &= ~((2u << lr) - 1u);
            }
            if (streak < 0 && sm) streak = (int)(base + __ffs((int)sm) - 1);
            if (bb) {
              jstar = (int)(base + __ffs((int)bb) - 1);
              break;
            }
          }
          tk = streak >= 0 ? streak : jstar;
        }
      }
      if (lane == 0) {
        s_t[k] = len > 0 ? tk : kBig;
        s_L[k] = len > 0 ? len : 0;
        s_orr[k] = orr_char;
      }
    }
    __syncthreads();

    // ---- phase 4: the next order and sr, shifted in rank order (so
    // neighbouring lanes write neighbouring ranks, mostly of one block);
    // new chars' metadata; deletes by coordinate. No rank is written here:
    // other blocks may still be integrating over the old ranks ----
    // The visible ones are counted per rank slice of the next step, for
    // its totals where its sr is carried (no barrier A then).
    const int m_new = m + nvalid;
    const View<kSmem> Rn = rank_view(m_new);   // the next step's slicing
    for (int base = rlo; base < rhi; base += kUnroll * kThreads) {
      int o[kUnroll];
      uint8_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        o[u] = i < rhi ? *Rk.own(ord, i) : 0;
        v[u] = i < rhi ? *Rk.own(sr, i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        int bin = -1;
        if (i < rhi) {
          int bump = 0;
          for (int k = 0; k < MB; ++k) bump += s_t[k] <= i ? s_L[k] : 0;
          const int nr = i + bump;
          if (nr < W) {
            *Rn.at(ord2, nr) = o[u];
            *Rn.at(sr2, nr) = v[u];
            if (v[u] == 1) bin = nr / Rn.S;
          }
        }
        count_bin(s_hist4, bin, lane);
      }
    }
    for (int base = 0; base < MC; base += kThreads) {
      const int k = base + tid;
      const Ch ch = base == 0 ? cur.ch
                    : k < MC ? load_ch(tp, tc, k)
                             : Ch{-1, 0, -1, 0, -1, 0, 0};
      const int slot = ch.slot;
      // a char of this block's slots (another block's, or a pad, not)
      const bool mine = slot >= lo && slot < hi;
      int bin = -1;
      if (mine) {
        const int bk = clampi(ch.blk, 0, MB - 1);
        int sb = s_t[bk];
        for (int q = 0; q < MB; ++q) sb += s_t[q] < s_t[bk] ? s_L[q] : 0;
        const int nr = sb + (k - s_start[bk]);
        if (nr >= 0 && nr < W) {
          const uint8_t v = *V.own(snap, slot);
          *Rn.at(ord2, nr) = slot;
          *Rn.at(sr2, nr) = v;
          if (v == 1) bin = nr / Rn.S;
        }
        const int ol_static = ch.ol_static, coord = ch.ol_coord;
        // an origin by a coordinate within the visible text was written
        // in phase 2; past it the search ends at W, where the order reads
        // 0 once an APPLY step has run (this buffer's tail is stale)
        if (ol_static != -2)
          *V.own(ol_id, slot) = ol_static;
        else if (coord <= 0)
          *V.own(ol_id, slot) = -1;
        else if (coord > total)
          *V.own(ol_id, slot) = W - 1 < m ? *Rk.at(ord, W - 1)
                                : !applied ? g.ord[r * W + W - 1] : 0;
        const int own = ch.orr_own;
        *V.own(orr_id, slot) = own >= 0 ? own : s_orr[bk];
        uint8_t* const sp = V.own(st, slot);
        *sp = max(*sp, (uint8_t)1);
      }
      count_bin(s_hist4, bin, lane);
    }
    for (int k = warp; k < MD; k += kWarps) {
      const Del d = k == warp ? cur.del : load_del(tp, td, k);
      if (d.kind != 0) continue;
      const int r0 =
          lower_bound_own(Rk, cum, rlo, rhi, (long long)d.a + 1 - below);
      const int r1 =
          lower_bound_own(Rk, cum, r0, rhi, (long long)d.b + 1 - below);
      for (int i = r0 + lane; i < r1; i += 32) {
        if (*Rk.own(sr, i) != 1) continue;
        const int s = *Rk.own(ord, i);
        if (s < 0 || s >= W) continue;
        *V.at(st, s) = 2;
        *V.at(ever, s) = 1;
      }
    }
    __syncthreads();
    publish_bins(cluster, s_hist4, s_tab, j, c, tid);
    csync();                                                   // E
    if (tid < kMaxCluster) s_hist4[tid] = 0;
    // the next step's tape, behind the step's last cluster barrier
    if (t + 1 < T) nxt = load_step(tp, t + 1, MB, MC, MD, tid, warp);

    // ---- phase 5: deletes by own slot range, the rank bump of the own
    // slots, then the new chars' ranks; the order and sr swap; m ----
    for (int k = warp; k < MD; k += kWarps) {
      const Del d = k == warp ? cur.del : load_del(tp, td, k);
      if (d.kind != 1) continue;
      const int a = max(d.a, lo);
      const int b = min(d.b, hi);
      for (int s = a + lane; s < b; s += 32) {
        *V.own(st, s) = 2;
        *V.own(ever, s) = 1;
      }
    }
    for (int base = lo; base < hi; base += kUnroll * kThreads) {
      int rs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = base + u * kThreads + tid;
        rs[u] = s < hi ? *V.own(rank, s) : kBig;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (rs[u] >= kBig) continue;
        int bump = 0;
        for (int k = 0; k < MB; ++k) bump += s_t[k] <= rs[u] ? s_L[k] : 0;
        *V.own(rank, base + u * kThreads + tid) = rs[u] + bump;
      }
    }
    __syncthreads();
    for (int k = tid; k < MC; k += kThreads) {
      const Ch ch = k == tid ? cur.ch : load_ch(tp, tc, k);
      const int slot = ch.slot;
      if (slot < lo || slot >= hi) continue;
      const int bk = clampi(ch.blk, 0, MB - 1);
      int sb = s_t[bk];
      for (int q = 0; q < MB; ++q) sb += s_t[q] < s_t[bk] ? s_L[q] : 0;
      *V.own(rank, slot) = sb + (k - s_start[bk]);
    }
    {
      int32_t* const o = ord;
      ord = ord2;
      ord2 = o;
      uint8_t* const v = sr;
      sr = sr2;
      sr2 = v;
    }
    m = m_new;
    applied = true;
    sr_valid = true;
    __syncthreads();
  }

  // ---- the slices back to the carry, once a launch; the order's tail
  // [m, W) is 0 after any APPLY step, as the JAX step's fresh order
  // scatter leaves it ----
  int32_t* const gord = g.ord + r * W;
  if constexpr (kSmem) {
    int32_t* const gi[5] = {g.rank, g.ol_id, g.orr_id, g.agent_k, g.seq_k};
    const int32_t* const si[5] = {rank, ol_id, orr_id, agent_k, seq_k};
#pragma unroll
    for (int q = 0; q < 5; ++q)
      for (int i = lo + tid; i < hi; i += kThreads)
        gi[q][r * W + i] = *V.own(si[q], i);
    for (int i = lo + tid; i < hi; i += kThreads) {
      g.snap[r * W + i] = *V.own(snap, i);
      g.ever[r * W + i] = *V.own(ever, i);
    }
    for (int q = 0; q < n_idx; ++q)
      for (int i = lo + tid; i < hi; i += kThreads)
        gstate[(size_t)q * W + i] = *V.own(state + q * stride, i);
  }
  if (applied) {
    // the order (in either buffer) by the final rank slicing, its tail
    // by the slot slicing; without an APPLY step it is left as it was
    const View<kSmem> Rf = rank_view(m);
    const int r0 = j * Rf.S;
    for (int i = r0 + tid; i < min(r0 + Rf.S, m); i += kThreads)
      gord[i] = *Rf.own(ord, i);
    for (int i = max(lo, m) + tid; i < hi; i += kThreads) gord[i] = 0;
  }
  if (j == 0 && tid == 0) g.m[r] = m;
  // no block leaves while another may still address its shared memory
  csync();
}

template <bool kSmem>
cudaError_t launch(const Tape& tp, const Carry& c, int B, int T, int W,
                   int plen, int n_idx, int MB, int MC, int MD, int cl,
                   cudaStream_t stream) {
  auto kern = zone_tape_kernel<kSmem>;
  const long long dyn = kSmem ? smem_bytes(W, n_idx, cl) : 0;
  if (dyn > kSmemBudget) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  if (cl > 8) {
    err = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * cl, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  if (err != cudaSuccess) return err;
  // a cluster that the card can never hold at once would not run
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kern, tp, c, T, W, plen, n_idx, MB, MC, MD);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a block of the shared-memory form takes for a
// cluster of c blocks, and the most a block may take.
long long dt_zone_tape_smem_bytes(int W, int n_idx, int c) {
  return smem_bytes(W, n_idx, c);
}

long long dt_zone_tape_smem_budget() { return kSmemBudget; }

// Launch on `stream`: a cluster of `cluster` blocks of 1024 threads per
// replica (grid = B * cluster; cluster in 1, 2, 4, 8, 16), the carry in
// shared memory when `smem` is nonzero (cum, sr, ord2 and sr2 are then unused
// and may be null), else in global memory; every step of the tape in order,
// the carry updated in place. MB <= 32. Returns the first CUDA error of the
// set-up or the launch: a slice that does not fit, an attribute the card
// refuses, or a cluster it cannot hold (cudaErrorInvalidConfiguration).
// Nothing retries at another size.
int dt_zone_tape_run(
    const void* op, const void* a, const void* b, const void* snap_flag,
    const void* blk_cursor, const void* blk_prev, const void* blk_root,
    const void* blk_start, const void* blk_len, const void* ch_slot,
    const void* ch_ol_static, const void* ch_ol_coord, const void* ch_orr_own,
    const void* ch_blk, const void* ch_agent, const void* ch_seq,
    const void* del_kind, const void* del_a, const void* del_b, void* state,
    void* snap, void* rank, void* ord, void* ol_id, void* orr_id, void* ever,
    void* m, void* agent_k, void* seq_k, void* cum, void* sr, void* ord2,
    void* sr2, int B, int T, int W, int plen, int n_idx, int MB, int MC, int MD,
    int cluster, int smem, void* stream) {
  if (MB > kMaxBlocks || MB < 0 || MC < 0 || MD < 0 || B < 1 || W < 1 ||
      n_idx < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  Tape tp{i32(op),         i32(a),          i32(b),          i32(snap_flag),
          i32(blk_cursor), i32(blk_prev),   i32(blk_root),   i32(blk_start),
          i32(blk_len),    i32(ch_slot),    i32(ch_ol_static),
          i32(ch_ol_coord), i32(ch_orr_own), i32(ch_blk),    i32(ch_agent),
          i32(ch_seq),     i32(del_kind),   i32(del_a),      i32(del_b)};
  Carry c{static_cast<uint8_t*>(state),  static_cast<uint8_t*>(snap),
          static_cast<int32_t*>(rank),   static_cast<int32_t*>(ord),
          static_cast<int32_t*>(ol_id),  static_cast<int32_t*>(orr_id),
          static_cast<uint8_t*>(ever),   static_cast<int32_t*>(m),
          static_cast<int32_t*>(agent_k), static_cast<int32_t*>(seq_k),
          static_cast<int32_t*>(cum),    static_cast<uint8_t*>(sr),
          static_cast<int32_t*>(ord2),   static_cast<uint8_t*>(sr2)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      smem ? launch<true>(tp, c, B, T, W, plen, n_idx, MB, MC, MD, cluster, s)
           : launch<false>(tp, c, B, T, W, plen, n_idx, MB, MC, MD, cluster,
                           s);
  return static_cast<int>(err);
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
