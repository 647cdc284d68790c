// The zone engine's step tape (X8) for B independent replicas, in ONE
// launch: the whole scan of the JAX package's zone executor.
//
// Replaces diamond_types_tpu/tpu/zone_kernel.py:480 make_zone_step, run by
// `_run_zone` / `_run_zone_slice` (zone_kernel.py:675-682, :751-758) as an
// XLA `lax.scan` (no `pallas_call`): every step is some 80-100 tensor
// operations over [W] slot planes and [MB, W] block masks, and the steps are
// strictly serial (each reads the rank and order the previous one wrote).
// Issued as PyTorch operations that is one launch per operation per step;
// here it is one launch per tape (or per slice of a tape), the carry updated
// in place so that a session continues it.
//
// Tape (shared by every replica), all int32: op, a, b, snap [T]; blk_cursor,
// blk_prev, blk_root, blk_start, blk_len [T, MB]; ch_slot, ch_ol_static,
// ch_ol_coord, ch_orr_own, ch_blk, ch_agent, ch_seq [T, MC]; del_kind,
// del_a, del_b [T, MD]. Carry (per replica): state [B, n_idx, W] u8, snap
// and ever [B, W] u8, rank, ord, ol_id, orr_id, agent_k, seq_k [B, W] i32,
// m [B] i32. Scratch (per replica, from the wrapper): cum [B, W] i32, sr
// [B, W] u8, ord2 [B, W] i32. BIG = 1 << 30 marks an unplaced rank.
//
// Design (a first, correct kernel). One thread block of 1024 threads per
// replica (grid = B) loops over the T steps; the carry stays in global
// memory, which for one replica fits in the 50 MB L2 up to W in the
// hundreds of thousands. Row steps (BEGIN, FORK, MAX) are one row copy or
// max. An APPLY step is six phases separated by __syncthreads():
//   1. the key planes (agent_k, seq_k of this step's chars), the snapshot
//      copy of the row on an entry's first sub-step, the step's blocks into
//      shared memory, and a count of its chars;
//   2. the snapshot state in rank order (sr = snap[ord[i]], i < m) and one
//      block-wide inclusive scan of its visible flags (cum), warp by warp
//      over contiguous segments;
//   3. warp k resolves block k: a = the cursor's rank (a binary search on
//      cum) or, for a continuation, the rank of the previous chunk's last
//      char; b = the first non-NotInsertedYet rank after a (a ballot scan
//      forward from a); then the YjsMod integrate over the ranks between a
//      and b alone (the JAX step's masked min/max reductions over all of W
//      reduce to a forward scan: the first break, the last reset before it,
//      the first set after that reset);
//   4. the rank bump and the next order: every placed rank i < m moves to
//      i + (chars of blocks placed at or before i) and is written into ord2
//      (rank[ord[i]] == i, so this is the JAX step's slot-space bump); the
//      new chars get their ranks, origin metadata (read against the OLD
//      order and cum, as the JAX step's ol_from_coord is) and Inserted
//      state; deletes by coordinate mark the visible ranks whose cum lies
//      in (a, b] (two binary searches), against the OLD order;
//   5. deletes by own slot range, then ord = ord2 over [0, m'), and on the
//      launch's first APPLY ord = 0 over [m', W), as the JAX step's fresh
//      order scatter leaves it; m = m'.
// Where the JAX step reads the old order (ch_at) after building the new one,
// this kernel reads `ord` before phase 5 copies ord2 over it; the integrate
// reads ranks before phase 4 bumps them. Writes aimed out of range (pad
// chars at W) are skipped; every clamped JAX gather is an explicit clamp
// plus its fill. The reductions are over integer indices, so the result is
// bit-identical to the plain version and the JAX scan on all ten carry
// planes.
//
// What bounds it on an H100 (3.35 TB/s HBM, 50 MB L2): bytes, in a serial
// chain of T steps. An APPLY step moves about ten int32 passes over the m
// placed ranks (order, scan, bump, rescatter, copy) plus a snapshot row of
// W bytes; a row step W to 2W bytes. The steps cannot overlap within a
// replica, so one replica's time is T times a step's latency through L2
// from ONE SM: one block per replica leaves the card mostly idle at B 1 (a
// cluster of blocks per replica is later work). At B in the hundreds every
// SM holds a replica and the carries spill from L2 to HBM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 32;       // MB: one warp per block of a step
constexpr int32_t kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

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
  int32_t* cum;   // scratch
  uint8_t* sr;    // scratch
  int32_t* ord2;  // scratch
};

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

// First i in [0, m) with cum[i] >= v, or m.
__device__ __forceinline__ int lower_bound_m(const int32_t* cum, int m,
                                             long long v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)cum[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// jnp.searchsorted(cum_full, v, side="left") where cum_full is cum over
// [0, m) followed by `total` up to W: the first such index, or W.
__device__ __forceinline__ int search_full(const int32_t* cum, int m, int W,
                                           long long v, int total) {
  const int lb = lower_bound_m(cum, m, v);
  if (lb < m) return lb;
  return (v <= total && m < W) ? m : W;
}

__global__ void __launch_bounds__(kThreads, 1)
zone_tape_kernel(Tape tp, Carry c, int T, int W, int plen, int n_idx, int MB,
                 int MC, int MD) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t r = blockIdx.x;
  uint8_t* const state = c.state + r * (size_t)n_idx * W;
  uint8_t* const snap = c.snap + r * W;
  int32_t* const rank = c.rank + r * W;
  int32_t* const ord = c.ord + r * W;
  int32_t* const ol_id = c.ol_id + r * W;
  int32_t* const orr_id = c.orr_id + r * W;
  uint8_t* const ever = c.ever + r * W;
  int32_t* const agent_k = c.agent_k + r * W;
  int32_t* const seq_k = c.seq_k + r * W;
  int32_t* const cum = c.cum + r * W;
  uint8_t* const sr = c.sr + r * W;
  int32_t* const ord2 = c.ord2 + r * W;

  __shared__ int s_cursor[kMaxBlocks], s_prev[kMaxBlocks], s_root[kMaxBlocks],
      s_start[kMaxBlocks], s_len[kMaxBlocks];
  __shared__ int s_t[kMaxBlocks], s_L[kMaxBlocks], s_orr[kMaxBlocks];
  __shared__ int s_cnt[kWarps], s_vis[kWarps];

  int m = c.m[r];
  bool tail_zeroed = false;

  for (int t = 0; t < T; ++t) {
    const int op = tp.op[t];
    if (op != 3) {
      // ---- row step: BEGIN / FORK / MAX (anything else is MAX) ----
      const int a = clampi(tp.a[t], 0, n_idx - 1);
      const int tgt = clampi(op == 0 ? tp.a[t] : tp.b[t], 0, n_idx - 1);
      const uint8_t* src = state + (size_t)a * W;
      uint8_t* dst = state + (size_t)tgt * W;
      for (int w = tid; w < W; w += kThreads) {
        uint8_t v;
        if (op == 0)
          v = w < plen ? 1 : 0;
        else if (op == 1)
          v = src[w];
        else
          v = max(dst[w], src[w]);
        dst[w] = v;
      }
      __syncthreads();
      continue;
    }

    // ---- APPLY, phase 1: keys, snapshot, blocks, char count ----
    const size_t tb = (size_t)t * MB, tc = (size_t)t * MC,
                 td = (size_t)t * MD;
    const int row = clampi(tp.a[t], 0, n_idx - 1);
    uint8_t* const st = state + (size_t)row * W;
    if (tid < MB) {
      s_cursor[tid] = tp.blk_cursor[tb + tid];
      s_prev[tid] = tp.blk_prev[tb + tid];
      s_root[tid] = tp.blk_root[tb + tid];
      s_start[tid] = tp.blk_start[tb + tid];
      s_len[tid] = tp.blk_len[tb + tid];
    }
    int nv = 0;
    for (int k = tid; k < MC; k += kThreads) {
      const int slot = tp.ch_slot[tc + k];
      if (slot >= 0) {
        ++nv;
        if (slot < W) {
          agent_k[slot] = tp.ch_agent[tc + k];
          seq_k[slot] = tp.ch_seq[tc + k];
        }
      }
    }
    nv = warp_sum(nv);
    if (lane == 0) s_cnt[warp] = nv;
    if (tp.snap[t] == 1)
      for (int w = tid; w < W; w += kThreads) snap[w] = st[w];
    __syncthreads();

    // ---- phase 2: sr in rank order, visible counts per warp segment ----
    const int seg = (m + kWarps - 1) / kWarps;
    const int lo = min(warp * seg, m), hi = min(lo + seg, m);
    int cnt = 0;
    for (int i = lo + lane; i < hi; i += 32) {
      const uint8_t s = snap[clampi(ord[i], 0, W - 1)];
      sr[i] = s;
      cnt += s == 1;
    }
    cnt = warp_sum(cnt);
    if (lane == 0) s_vis[warp] = cnt;
    __syncthreads();
    int nvalid = 0, off = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      nvalid += s_cnt[w];
      if (w < warp) off += s_vis[w];
      total += s_vis[w];
    }
    {
      int run = off;
      for (int base = lo; base < hi; base += 32) {
        const int i = base + lane;
        const int v = (i < hi && sr[i] == 1) ? 1 : 0;
        const int incl = warp_incl_scan(v, lane);
        if (i < hi) cum[i] = run + incl;
        run += __shfl_sync(kFull, incl, 31);
      }
    }
    __syncthreads();

    // ---- phase 3: warp k resolves and integrates block k ----
    if (warp < MB) {
      const int k = warp;
      const int len = s_len[k];
      int tk = kBig, orr_char = -1;
      if (len > 0) {
        const int cursor = s_cursor[k], prev = s_prev[k], root = s_root[k];
        const bool is_cont = cursor == -2;
        int a_rank;
        if (is_cont)
          a_rank = prev >= 0 ? rank[min(prev, W - 1)] : kBig;
        else if (cursor <= 0)
          a_rank = -1;
        else
          a_rank = search_full(cum, m, W, cursor, total);
        // b0: the first rank after a_rank that is placed and not NIY
        int b0 = W;
        for (long long base = max((long long)a_rank + 1, 0LL); base < m;
             base += 32) {
          const long long i = base + lane;
          const unsigned bal = __ballot_sync(kFull, i < m && sr[i] != 0);
          if (bal) {
            b0 = (int)(base + __ffs((int)bal) - 1);
            break;
          }
        }
        orr_char = b0 < m ? ord[b0] : -1;
        const int b_rank = min(b0, m);
        if (is_cont) {
          tk = a_rank + 1;
        } else {
          const int agent_c = root >= 0 ? agent_k[min(root, W - 1)] : 0;
          const int seq_c = root >= 0 ? seq_k[min(root, W - 1)] : 0;
          const int b_eff = orr_char < 0 ? kBig : b_rank;
          int jstar = b_rank, streak = -1;
          for (long long base = max((long long)a_rank + 1, 0LL);
               base < b_rank; base += 32) {
            const long long i = base + lane;
            bool brk = false, setv = false, resetv = false;
            if (i < b_rank) {
              const int s = ord[i];
              const int sc = clampi(s, 0, W - 1);
              const int olw = s >= 0 ? ol_id[sc] : -3;
              const int olr =
                  olw == -1 ? -1 : (olw >= 0 ? rank[min(olw, W - 1)] : kBig);
              const int orw = s >= 0 ? orr_id[sc] : -3;
              const int orr_r =
                  orw == -1 ? kBig : (orw >= 0 ? rank[min(orw, W - 1)] : kBig);
              const int ag = s >= 0 ? agent_k[sc] : 0;
              const int sq = s >= 0 ? seq_k[sc] : 0;
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

    // ---- phase 4: bump + next order, new chars, deletes by coordinate ----
    const int m_new = m + nvalid;
    for (int i = tid; i < m; i += kThreads) {
      const int slot = ord[i];
      int bump = 0;
      for (int k = 0; k < MB; ++k) bump += s_t[k] <= i ? s_L[k] : 0;
      const int nr = i + bump;
      if (slot >= 0 && slot < W) rank[slot] = nr;
      if (nr >= 0 && nr < W) ord2[nr] = slot;
    }
    for (int k = tid; k < MC; k += kThreads) {
      const int slot = tp.ch_slot[tc + k];
      if (slot < 0 || slot >= W) continue;
      const int bk = clampi(tp.ch_blk[tc + k], 0, MB - 1);
      int sb = s_t[bk];
      for (int j = 0; j < MB; ++j) sb += s_t[j] < s_t[bk] ? s_L[j] : 0;
      const int nr = sb + (k - s_start[bk]);
      rank[slot] = nr;
      if (nr >= 0 && nr < W) ord2[nr] = slot;
      const int ol_static = tp.ch_ol_static[tc + k];
      int ol = ol_static;
      if (ol_static == -2) {
        const int coord = tp.ch_ol_coord[tc + k];
        ol = coord <= 0
                 ? -1
                 : ord[clampi(search_full(cum, m, W, coord, total), 0, W - 1)];
      }
      const int own = tp.ch_orr_own[tc + k];
      ol_id[slot] = ol;
      orr_id[slot] = own >= 0 ? own : s_orr[bk];
      st[slot] = max(st[slot], (uint8_t)1);
    }
    for (int k = warp; k < MD; k += kWarps) {
      if (tp.del_kind[td + k] != 0) continue;
      const int r0 = lower_bound_m(cum, m, (long long)tp.del_a[td + k] + 1);
      const int r1 = lower_bound_m(cum, m, (long long)tp.del_b[td + k] + 1);
      for (int i = r0 + lane; i < r1; i += 32) {
        if (sr[i] != 1) continue;
        const int s = ord[i];
        if (s < 0 || s >= W) continue;
        st[s] = 2;
        ever[s] = 1;
      }
    }
    __syncthreads();

    // ---- phase 5: deletes by own slot range, the new order, m ----
    for (int k = warp; k < MD; k += kWarps) {
      if (tp.del_kind[td + k] != 1) continue;
      const int a = max(tp.del_a[td + k], 0);
      const int b = min(tp.del_b[td + k], W);
      for (int s = a + lane; s < b; s += 32) {
        st[s] = 2;
        ever[s] = 1;
      }
    }
    for (int i = tid; i < m_new && i < W; i += kThreads) ord[i] = ord2[i];
    if (!tail_zeroed) {
      for (int i = m_new + tid; i < W; i += kThreads) ord[i] = 0;
      tail_zeroed = true;
    }
    m = m_new;
    __syncthreads();
  }
  if (tid == 0) c.m[r] = m;
}

}  // namespace

extern "C" {

// Launch on `stream`: one block of 1024 threads per replica (grid = B),
// every step of the tape in order, the carry updated in place. MB <= 32.
// Returns cudaGetLastError() after the launch.
int dt_zone_tape_run(
    const void* op, const void* a, const void* b, const void* snap_flag,
    const void* blk_cursor, const void* blk_prev, const void* blk_root,
    const void* blk_start, const void* blk_len, const void* ch_slot,
    const void* ch_ol_static, const void* ch_ol_coord, const void* ch_orr_own,
    const void* ch_blk, const void* ch_agent, const void* ch_seq,
    const void* del_kind, const void* del_a, const void* del_b, void* state,
    void* snap, void* rank, void* ord, void* ol_id, void* orr_id, void* ever,
    void* m, void* agent_k, void* seq_k, void* cum, void* sr, void* ord2,
    int B, int T, int W, int plen, int n_idx, int MB, int MC, int MD,
    void* stream) {
  if (MB > kMaxBlocks || MB < 0 || MC < 0 || MD < 0 || B < 1 || W < 1 ||
      n_idx < 1)
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
          static_cast<int32_t*>(ord2)};
  zone_tape_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tp, c, T, W, plen, n_idx, MB, MC, MD);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
