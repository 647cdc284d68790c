// Fused window replay (K1): a whole [b, n] op tape applied to [b, cap]
// document rows in ONE launch.
//
// Replaces the TPU kernel diamond_types_tpu/tpu/pallas_kernels.py::
// apply_op_block (body _apply_op_rows_kernel), which applies ONE op per row
// and is launched n times per window inside a lax.scan
// (tpu/flush_fuse.py::make_pallas_replay_body). This kernel computes that
// whole window function:
//   1. ops with dlen > max_ins or ilen > max_ins are zeroed to no-ops, and
//      so are ops with a negative pos, dlen or ilen (the planner never
//      emits them);
//   2. the n ops are applied in order, each as
//        out[i] = doc[i]                          for i < pos
//               = chars[i - pos]                  for pos <= i < pos + ilen
//               = doc[(i - ilen + dlen) mod cap]  otherwise (a roll: wraps)
//      and a no-op when ilen == dlen == 0 or pos >= cap;
//   3. len += ilen - dlen per applied op (int32, wrapping), and a row with
//      any out-of-contract op returns length -1 (a row that comes in at -1
//      with all-zero ops stays at -1).
// Requires max_ins <= cap (the wrapper checks it).
//
// Design: the window as an index map. Each output element can be found on
// its own by walking the op tape BACKWARDS from the last op: start with o =
// the output index; for op k = n-1 .. 0 (no-ops skipped), o < p keeps o;
// p <= o < p + ilen means the element is chars[k][o - p] and the walk
// stops; otherwise o = o - ilen + dlen, minus cap once if that reaches cap
// (once is enough: dlen <= max_ins <= cap). A walk that never stops reads
// docs[r, o]. So no op is applied to the row: the row is gathered once.
//   * Grid: one CTA per (row, tile of kTile elements of the cap axis),
//     flattened, so a bucket of 8 rows at cap 32,768 is 512 CTAs, not 8.
//   * Staging: each CTA stages its row's op tape into shared memory as
//     int4 {p, dlen, ilen, k}, kOpTile ops at a time, walked from the last
//     tile to the first. Ops out of contract and no-ops get p = INT32_MAX,
//     which every walk passes over at the cost of one compare. The CTA of
//     tile 0 also sums the length and the poison flag and writes out_lens.
//   * Jumps. Beside each staged op j the CTA keeps {lo, hi, d} (a block
//     scan over the tile, `stage_jumps`): a run [o, o + w) with lo <= o and
//     o + w <= hi lies past the insert lane of every op 0 .. j and no shift
//     wraps it, so ops j .. 0 move it to o + d in one step. The text past
//     every op (most of a row: sessions keep headroom past the live text)
//     then costs one step per tile instead of one per op.
//   * Runs, not elements. A warp's 32 * kPer outputs start as one run
//     [lo, lo + W). While the run lies wholly on one side of an op's
//     boundaries, the op moves the whole run, which is two scalars, the
//     same in every lane: wholly below p, unchanged; wholly at or past
//     p + ilen, shifted (and still one run unless the shift crosses cap);
//     wholly inside the insert lane, resolved to chars. An op with a
//     boundary inside the run splits it: from that op each lane walks its
//     own kPer-element run the same way, and a lane whose run splits walks
//     its elements one by one, all kPer in step. Every mode is exact. In a
//     window of a few hundred ops over an 8K-32K document most warps of
//     the live text split somewhere, but few 4-element runs do, so the work
//     is O(n) steps per warp and then per lane, for 128 outputs, instead
//     of the O(n * cap) element moves of an in-place replay. The ops are
//     read from shared memory four at a time ahead of their steps.
//   * Gather and store: a run that ends on the row reads docs contiguously
//     (16-byte loads where aligned), chars reads come from the row's tape
//     (in L2 for every tile after the first), stores are 16-byte where the
//     row is aligned, coalesced across the warp.
//
// What bounds it on an H100 (3.35 TB/s HBM): device memory sees each row
// read about once and written once plus the op tape, 2*b*cap*4 +
// b*n*(3+mi)*4 bytes; the tape's scalars are read again by every tile of a
// row, from L2. But the walk costs some instructions per op per warp (and
// per lane once a warp splits), n steps in a dependent chain: at the main
// path's tapes (n 256) the walk, not memory, sets the time. On a small
// bucket few warps are in flight and the longest chain decides; on a wide
// one every SM is busy and the instruction count does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;          // threads per CTA
constexpr int kPer = 4;                // consecutive outputs per lane
static_assert(kPer == 4, "the 16-byte gather and store take 4 per lane");
constexpr int kWarpRun = 32 * kPer;    // outputs per warp
constexpr int kTile = kThreads * kPer; // outputs per CTA
constexpr int kOpTile = 512;           // ops staged in shared memory at once
constexpr int kSkip = 0x7fffffff;      // p of an op that every walk skips
constexpr int kWarps = kThreads / 32;
constexpr long long kNoOp = -(1LL << 62);  // max over no op

__device__ __forceinline__ int clamp32(long long v) {
  return v < INT32_MIN ? INT32_MIN : (v > INT32_MAX ? INT32_MAX : (int)v);
}

// jump[j] = {lo, hi, d} for the staged ops[0 .. m) (see the header). With
// D[j] = sum over i <= j of (dlen_i - ilen_i) (skipped ops add 0), op i
// shifts the run [x, x + w) it sees wholly, without a wrap, when
// x >= p_i + ilen_i and x - ilen_i + dlen_i + w <= cap; walked back from
// op j, op i sees x = o + D[j] - D[i]. So
//   lo = max over live i <= j of (p_i + ilen_i + D[i]) - D[j],
//   hi = cap + min over i <= j of D[i - 1] - D[j]  (D[-1] = 0),
//   d  = D[j],
// formed in 64 bits and clamped to int32 (a clamped bound decides the same
// compare for any run inside the row). Each thread scans a chunk of
// consecutive ops; chunks combine across the block through shuffles and
// shared memory. Every thread calls it, between barriers.
__device__ __forceinline__ void stage_jumps(const int4* __restrict__ ops,
                                            int4* __restrict__ jump, int m,
                                            int cap, int t, int* wsum,
                                            long long* wmax,
                                            long long* wmin) {
  const int lane = t & 31;
  const int w = t >> 5;
  const int c = (m + kThreads - 1) / kThreads;
  const int j0 = min(t * c, m);
  const int j1 = min(j0 + c, m);
  int dsum = 0;
  for (int j = j0; j < j1; ++j) dsum += ops[j].y - ops[j].z;
  int incl = dsum;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += x;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  int base = incl - dsum;                          // D before the chunk
  for (int i = 0; i < w; ++i) base += wsum[i];
  long long mx = kNoOp, mn = INT64_MAX;            // the chunk's own
  int d = base;
  for (int j = j0; j < j1; ++j) {
    const int4 op = ops[j];
    mn = min(mn, (long long)d);
    d += op.y - op.z;
    if (op.x != kSkip) mx = max(mx, (long long)op.x + op.z + d);
  }
  long long smx = mx, smn = mn;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const long long x = __shfl_up_sync(kFull, smx, s);
    const long long y = __shfl_up_sync(kFull, smn, s);
    if (lane >= s) {
      smx = max(smx, x);
      smn = min(smn, y);
    }
  }
  if (lane == 31) {
    wmax[w] = smx;
    wmin[w] = smn;
  }
  long long pmx = __shfl_up_sync(kFull, smx, 1);   // the chunks before
  long long pmn = __shfl_up_sync(kFull, smn, 1);
  if (lane == 0) {
    pmx = kNoOp;
    pmn = INT64_MAX;
  }
  __syncthreads();
  for (int i = 0; i < w; ++i) {
    pmx = max(pmx, wmax[i]);
    pmn = min(pmn, wmin[i]);
  }
  d = base;
  for (int j = j0; j < j1; ++j) {
    const int4 op = ops[j];
    pmn = min(pmn, (long long)d);
    d += op.y - op.z;
    if (op.x != kSkip) pmx = max(pmx, (long long)op.x + op.z + d);
    jump[j] = make_int4(clamp32(pmx - d), clamp32(cap + pmn - d), d, 0);
  }
}

// One op's effect on the run [o, o + w) of outputs (w >= 1), walked
// backwards: 0 when the op keeps or shifts the whole run (o updated), 1
// when one of its boundaries splits the run (o unchanged), 2 when the run
// lies wholly in its insert lane (o = -(1 + index of the run's first char
// in the row's chars tape)). Branches, not selects: most ops leave a run
// below them and cost one compare (the faster form on the card at the
// widest bucket, where every SM is busy and instructions count).
__device__ __forceinline__ int step(int& o, int w, const int4 op, int cap,
                                   int mi) {
  if (o + w <= op.x) return 0;                     // wholly below p
  const int ins_end = op.x + op.z;
  if (o >= ins_end) {                              // wholly in the tail
    int s = o - op.z + op.y;
    if (s >= cap) {
      s -= cap;
    } else if (s + w > cap) {
      return 1;                                    // the shift wraps inside
    }
    o = s;
    return 0;
  }
  if (o >= op.x && o + w <= ins_end) {             // wholly in the lane
    o = -(1 + op.w * mi + (o - op.x));
    return 2;
  }
  return 1;                                        // a boundary inside
}

// Walk the run [o, o + w) back through ops k .. 0 of the staged tile. On
// return either
//   * the run resolved to chars (o < 0) or every op was walked (o is the
//     run's index before op 0): return -1;
//   * op k splits the run: return k, with o the run's index after op k.
// Ops are loaded four at a time ahead of their steps, so the shared-memory
// latency overlaps the dependent steps.
__device__ __forceinline__ int walk(int& o, int w, int k,
                                    const int4* __restrict__ ops, int cap,
                                    int mi) {
  for (; k >= 3; k -= 4) {
    const int4 a = ops[k], b = ops[k - 1], c = ops[k - 2], d = ops[k - 3];
    int s;
    if ((s = step(o, w, a, cap, mi))) return s == 1 ? k : -1;
    if ((s = step(o, w, b, cap, mi))) return s == 1 ? k - 1 : -1;
    if ((s = step(o, w, c, cap, mi))) return s == 1 ? k - 2 : -1;
    if ((s = step(o, w, d, cap, mi))) return s == 1 ? k - 3 : -1;
  }
  for (; k >= 0; --k) {
    const int s = step(o, w, ops[k], cap, mi);
    if (s) return s == 1 ? k : -1;
  }
  return -1;
}

// One op on kPer single elements in step (never splits), as selects (the
// lanes of a split warp disagree, so branches would diverge: on buckets
// of 8 rows, where a few warps set the time, selects were the faster
// form on the card). Resolved elements (< 0)
// lie below every p and stay as they are; elements past the row are
// walked too and never read.
__device__ __forceinline__ void step_each(int (&o)[kPer], const int4 op,
                                          int cap, int mi) {
  const int ins_end = op.x + op.z;
  const int base = op.w * mi - op.x;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int x = o[e];
    int s = x - op.z + op.y;
    s = s >= cap ? s - cap : s;
    o[e] = x < op.x ? x : (x < ins_end ? -(1 + base + x) : s);
  }
}

// kPer single elements through ops k .. 0, four ops loaded at a time.
__device__ __forceinline__ void walk_each(int (&o)[kPer], int k,
                                          const int4* __restrict__ ops,
                                          int cap, int mi) {
  for (; k >= 3; k -= 4) {
    const int4 a = ops[k], b = ops[k - 1], c = ops[k - 2], d = ops[k - 3];
    step_each(o, a, cap, mi);
    step_each(o, b, cap, mi);
    step_each(o, c, cap, mi);
    step_each(o, d, cap, mi);
  }
  for (; k >= 0; --k) step_each(o, ops[k], cap, mi);
}

// o[e] of a run that starts at o0: the run's elements in order, chars
// indices counting on in the tape when the run resolved to chars.
__device__ __forceinline__ void expand(int (&o)[kPer], int o0) {
#pragma unroll
  for (int e = 0; e < kPer; ++e) o[e] = o0 < 0 ? o0 - e : o0 + e;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
apply_ops_window_kernel(const int32_t* __restrict__ docs,
                        const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ pos,
                        const int32_t* __restrict__ dlen,
                        const int32_t* __restrict__ ilen,
                        const int32_t* __restrict__ chars,
                        int32_t* __restrict__ out_docs,
                        int32_t* __restrict__ out_lens,
                        int n, int cap, int mi, int tiles) {
  __shared__ int4 ops[kOpTile];
  __shared__ int4 jump[kOpTile];
  __shared__ int wsum[kWarps];
  __shared__ long long wmax[kWarps], wmin[kWarps];
  __shared__ unsigned len_sum;
  const int64_t r = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)(r * tiles);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp_lo = tile * kTile + (t >> 5) * kWarpRun;
  const int lo = warp_lo + lane * kPer;            // this lane's outputs
  // how many of them lie inside the row. `full` is its own compare: as
  // `valid == kPer` of a max/min clamp, the compiled guard also held in
  // lanes with no element in the row (seen in the SASS and on the card),
  // and those lanes stored into the next row
  const int rest = cap - lo;
  const int valid = rest <= 0 ? 0 : (rest < kPer ? rest : kPer);
  const bool full = rest >= kPer;
  const int warp_w = max(0, min(kWarpRun, cap - warp_lo));
  const int32_t* tape_pos = pos + r * n;
  const int32_t* tape_dl = dlen + r * n;
  const int32_t* tape_il = ilen + r * n;
  const bool first_tile = tile == 0;
  if (first_tile && t == 0) len_sum = 0;

  int o[kPer];
  expand(o, lo);
  // walking: the warp's outputs still form the one run [wo, wo + warp_w)
  bool warp_run = warp_w > 0;
  int wo = warp_lo;
  bool bad = false;
  unsigned my_sum = 0;

  for (int k1 = ((n - 1) / kOpTile) * kOpTile; k1 >= 0; k1 -= kOpTile) {
    const int m = min(kOpTile, n - k1);
    __syncthreads();  // the previous op tile is no longer read
    for (int j = t; j < m; j += kThreads) {
      const int k = k1 + j;
      const int p = tape_pos[k];
      const int dl = tape_dl[k];
      const int il = tape_il[k];
      const bool out = dl > mi || il > mi || dl < 0 || il < 0 || p < 0;
      bad |= out;
      if (!out) my_sum += static_cast<unsigned>(il - dl);
      ops[j] = out || (dl == 0 && il == 0) || p >= cap
                   ? make_int4(kSkip, 0, 0, k)
                   : make_int4(p, dl, il, k);
    }
    __syncthreads();
    stage_jumps(ops, jump, m, cap, t, wsum, wmax, wmin);
    __syncthreads();
    int k = m - 1;
    if (warp_run) {                                // uniform in the warp
      if (k >= 0) {
        const int4 jp = jump[k];
        if (wo >= jp.x && wo + warp_w <= jp.y) {   // every op moves it alike
          wo += jp.z;
          continue;
        }
      }
      k = walk(wo, warp_w, k, ops, cap, mi);
      if (k < 0 && wo >= 0) continue;              // still one run
      const int off = lo - warp_lo;
      expand(o, wo < 0 ? wo - off : wo + off);
      warp_run = false;
      if (k < 0) continue;                         // resolved to chars
      // k splits the warp's run; lanes go on from k
    }
    if (k < 0) continue;
    // this lane's run, if its elements still form one
    bool lane_run = valid > 0 && o[0] >= 0;
#pragma unroll
    for (int e = 1; e < kPer; ++e)
      if (e < valid && o[e] != o[0] + e) lane_run = false;
    if (lane_run) {
      int lo0 = o[0];
      const int4 jp = jump[k];
      if (lo0 >= jp.x && lo0 + valid <= jp.y) {
        lo0 += jp.z;
        k = -1;
      } else {
        k = walk(lo0, valid, k, ops, cap, mi);
      }
      expand(o, lo0);
    }
    walk_each(o, k, ops, cap, mi);
  }
  // the ops are applied: offset every element by the row's tape
  // (chars indices were made relative to the row)
  const int32_t* src_row = docs + r * cap;
  const int32_t* ch = chars + r * (int64_t)n * mi;
  int32_t v[kPer];
  if (kAligned && warp_run && full && ((wo + lo - warp_lo) & 3) == 0) {
    const int4 x = *reinterpret_cast<const int4*>(src_row + wo + lo - warp_lo);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    if (warp_run) expand(o, wo + lo - warp_lo);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (e < valid) v[e] = o[e] >= 0 ? src_row[o[e]] : ch[-1 - o[e]];
  }
  int32_t* dst = out_docs + r * cap + lo;
  if (kAligned && full) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (e < valid) dst[e] = v[e];
  }

  if (first_tile) {                                // the row's length
    const bool any_bad = __syncthreads_or(bad);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) my_sum += __shfl_xor_sync(kFull, my_sum, s);
    if (lane == 0) atomicAdd(&len_sum, my_sum);
    __syncthreads();
    if (t == 0)
      out_lens[r] = any_bad ? -1
                            : static_cast<int32_t>(
                                  static_cast<unsigned>(lens[r]) + len_sum);
  }
}

}  // namespace

extern "C" {

// CTAs one launch uses at (b, cap): rows times tiles of the cap axis.
long long dt_apply_ops_window_ctas(int b, int cap) {
  return static_cast<long long>(b) * ((cap + kTile - 1) / kTile);
}

// Launch on `stream` (b >= 1, n >= 0, 1 <= mi <= cap). Rows take 16-byte
// accesses when docs and out_docs are 16-byte aligned and cap % 4 == 0.
// Returns cudaGetLastError() after the launch.
int dt_apply_ops_window(const void* docs, const void* lens, const void* pos,
                        const void* dlen, const void* ilen, const void* chars,
                        void* out_docs, void* out_lens, int b, int n, int cap,
                        int mi, void* stream) {
  const int tiles = (cap + kTile - 1) / kTile;
  const long long grid = dt_apply_ops_window_ctas(b, cap);
  const bool aligned =
      cap % 4 == 0 && ((reinterpret_cast<uintptr_t>(docs) |
                        reinterpret_cast<uintptr_t>(out_docs)) & 15) == 0;
  auto* kernel = aligned ? apply_ops_window_kernel<true>
                         : apply_ops_window_kernel<false>;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(docs), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(dlen),
      static_cast<const int32_t*>(ilen), static_cast<const int32_t*>(chars),
      static_cast<int32_t*>(out_docs), static_cast<int32_t*>(out_lens), n,
      cap, mi, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
