// Device checkout's text assembly (K3): for each document row, lay the
// runs out in document order,
//   vl[i]    = vis_len[perm[i]]
//   start[i] = sum(vl[0..i))                       (exclusive prefix sum)
//   out[start[i] + k] = arena[clamp(arena_off[perm[i]] + k, 0, pool - 1)]
//                     for 0 <= k < vl[i] and start[i] + k < cap
//   out[j] = 0 for min(total, cap) <= j < cap,    total = sum(vl) (unclipped)
// on perm, vis_len, arena_off [b, n] int32 and arena [b, pool] int32, in
// int32 arithmetic that wraps, perm clamped to [0, n) before it indexes.
// perm, arena_off and arena each have a row stride: their own row length,
// or 0 for ONE row that every document shares (the history path's
// versions share the order, the offsets and the arena). It
// is the function of the JAX package's materialize_jax and of the port's
// linearize.materialize wherever vis_len >= 0 and arena_off[perm[i]] -
// start[i] < 2^30 (the plain versions park that difference with a bias of
// 2^30), which every in-contract input (arena_off < pool) meets.
//
// Replaces the TPU kernel diamond_types_tpu/tpu/pallas_kernels.py:211
// materialize_pallas (body _materialize_runs_kernel, :144): a sequential
// grid of one step per run over run tables held in SMEM, which bounds them
// at 8,192 runs and falls back to XLA past that, one document per call.
//
// Design: ONE wrapper call is TWO kernels on the caller's stream, with no
// host sync between them; the gather is a programmatic dependent launch,
// so its CTAs are resident before the scan ends and wait on the card
// (griddepcontrol) rather than behind a second launch.
//   1. Row scan, one CTA of kScanThreads per row. Each thread owns 4
//      consecutive runs of a step of kScanThreads * 4: it reads perm (16
//      bytes where aligned) and gathers vl = vis_len[perm] and base =
//      arena_off[perm] once; a shuffle scan in each warp and one across
//      the warps' sums (shared memory, one barrier) place the runs, and
//      the carry passes from step to step, so any n works. It writes a
//      scratch row: the (start, base) pairs, (total, 0) at n, with 16-byte
//      stores; seg_first, for every segment of kSeg outputs, the live run
//      that holds the segment's first output (its only writer); after them
//      the run that holds output min(total, cap) - 1 (the last live run
//      that starts before cap, a max over the CTA); and total [b].
//      Not K2's one warp per row: a row of the main path's 2,048 runs is a
//      chain of dependent loads and shuffles, and with one warp per row
//      nothing hides it; a CTA per row walks 2,048 runs in one step.
//   2. Tiled output gather over rows x tiles of kTile outputs, kGatherThreads
//      per CTA. Each thread owns 4 consecutive outputs; a warp owns one
//      segment of kSeg. The run holding output j is the last live run whose
//      start is <= j, and a segment's outputs lie in the runs lo .. hi from
//      its seg_first to the next segment's (or the row's last live run).
//      Where hi - lo < kMarkRuns (warp-uniform), each live run in (lo, hi]
//      that starts inside the segment writes its index at its start in a
//      shared row of kSeg marks, and a running max of the marks (4 in a
//      thread, then a shuffle scan over the warp), from lo, is each
//      output's run. Zero-length runs never mark, and none can share a
//      live run's start after it, so none is chosen. Else (a long stretch
//      of zero-length runs) each thread finds the run of its first output
//      by an upper-bound binary search of the starts in [lo, hi] (first u
//      with start[u] > j, run u - 1, so a zero-length run that shares its
//      start with a live run is never chosen) and searches again from the
//      current run where a later output crosses a run end. Marks, not
//      searches, on the common path: a search per thread, and again at
//      each run end, is a divergent loop whose issue slots cost more than
//      the copy itself. The source is base[run]
//      + (j - start[run]), clamped to the pool. Stores are 16 bytes where
//      the row is aligned, scalar at a ragged row end; outputs at or past
//      min(total, cap) are zero, so a tile wholly past the text stores
//      zeros only.
//
// Why a grid over output tiles. Every output has exactly one source, so the
// work is an output-stationary gather and its parallelism is b * cap, not
// b (documents) or runs. One CTA per document used 1.23 waves of 132 SMs at
// the main path's widest call (b 163) and one SM in a merge (b 1); runs of
// a few chars left a warp per run mostly idle. With kTile = 512 a b-1 merge
// at cap 16,384 gets 32 CTAs and the widest call 5,216.
//
// What bounds it on an H100 (3.35 TB/s HBM): bytes. The run tables are read
// once (3*b*n*4), the visible text once (sum(min(total, cap))*4), the output
// written once (b*cap*4) and the totals (4b). The scratch rows (8 bytes a
// run and 4 a segment, written, then read) are the design's own traffic and
// are not counted in the bound; they are small beside the output. Below
// the bound the two kernels' chains of dependent loads (perm, then the
// gathers through it; seg_first, then the pairs, then the arena) set the
// time of a small call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 4;                       // runs, or outputs, a thread
constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kStep = kScanThreads * kVec;    // runs per scan step
constexpr int kGatherThreads = 128;
constexpr int kTile = kGatherThreads * kVec;  // outputs per gather CTA
constexpr int kSeg = 32 * kVec;               // outputs per warp: a segment
constexpr int kMarkRuns = 256;                // runs a segment may mark

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

// One thread's 4 perm entries [i0, i0 + 4), clamped to [0, n); -1 past n.
// kAligned: perm is 16-byte aligned and n % 4 == 0.
template <bool kAligned>
__device__ __forceinline__ void load_perm(const int32_t* __restrict__ pr,
                                          int i0, int n, int32_t (&p)[kVec]) {
  if (kAligned && i0 + kVec <= n) {
    const int4 x = *reinterpret_cast<const int4*>(pr + i0);
    p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = min(max(p[e], 0), n - 1);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    p[e] = i0 + e < n ? min(max(pr[i0 + e], 0), n - 1) : -1;
}

// Pass 1: the row scan, one CTA per row. Scratch row r is `row` int32 from
// table + r * row: the (start, base) pairs [0, n], then seg_first [segs + 1]
// from int 2 * stride.
template <bool kAligned>
__global__ void __launch_bounds__(kScanThreads)
scan_runs_kernel(const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ vis_len,
                 const int32_t* __restrict__ arena_off,
                 int32_t* __restrict__ table, int32_t* __restrict__ total_out,
                 int n, int cap, int stride, int row, int64_t perm_rs,
                 int64_t off_rs) {
  // the gather may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ uint32_t warp_sum[kScanWarps];
  __shared__ int last_live;  // the last live run that starts before cap
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t r = blockIdx.x;
  const int32_t* pr = perm + r * perm_rs;
  const int32_t* vr = vis_len + r * n;
  const int32_t* ar = arena_off + r * off_rs;
  if (threadIdx.x == 0) last_live = -1;
  int32_t* pairs = table + r * row;
  int32_t* seg_first = pairs + 2 * stride;
  const int segs = (cap + kSeg - 1) / kSeg;
  uint32_t carry = 0;  // sum of vl before the step, wrapping; CTA-uniform
  int my_last = -1;
  for (int c0 = 0; c0 < n; c0 += kStep) {
    const int i0 = c0 + threadIdx.x * kVec;
    int32_t p[kVec], v[kVec], a[kVec];
    load_perm<kAligned>(pr, i0, n, p);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      v[e] = p[e] >= 0 ? vr[p[e]] : 0;
      a[e] = p[e] >= 0 ? ar[p[e]] : 0;
    }
    uint32_t sum = 0;  // the thread's own runs
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += (uint32_t)v[e];
    const uint32_t inc = warp_incl_scan(sum, lane);
    if (lane == 31) warp_sum[w] = inc;
    __syncthreads();
    const uint32_t ws = lane < kScanWarps ? warp_sum[lane] : 0u;
    const uint32_t wi = warp_incl_scan(ws, lane);
    uint32_t s = carry + __shfl_sync(kFull, wi - ws, w) + inc - sum;
    carry += __shfl_sync(kFull, wi, kScanWarps - 1);
    int32_t st[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      st[e] = (int32_t)s;
      s += (uint32_t)v[e];
    }
    if (i0 + kVec <= n) {
      int4* q = reinterpret_cast<int4*>(pairs + 2 * i0);
      q[0] = make_int4(st[0], a[0], st[1], a[1]);
      q[1] = make_int4(st[2], a[2], st[3], a[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (i0 + e < n) {
          pairs[2 * (i0 + e)] = st[e];
          pairs[2 * (i0 + e) + 1] = a[e];
        }
    }
    // the segments whose first output a live run holds
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (i0 + e >= n || v[e] <= 0 || st[e] < 0 || st[e] >= cap) continue;
      my_last = i0 + e;
      const long long end = (long long)st[e] + v[e];
      const int g1 = (int)min((end + kSeg - 1) / kSeg, (long long)segs);
      for (int g = (st[e] + kSeg - 1) / kSeg; g < g1; ++g)
        seg_first[g] = i0 + e;
    }
    __syncthreads();  // warp_sum is rewritten by the next step
  }
  // the run holding output min(total, cap) - 1: it bounds the search of
  // the last segment that holds text, past which only zero-length
  // (padding) runs follow
  if (my_last >= 0) atomicMax(&last_live, my_last);
  __syncthreads();
  if (threadIdx.x == 0) {
    seg_first[segs] = last_live;
    pairs[2 * n] = (int32_t)carry;
    pairs[2 * n + 1] = 0;
    total_out[r] = (int32_t)carry;
  }
}

// First u in [lo, hi) with pairs[u].start > j, else hi.
__device__ __forceinline__ int upper_bound(const int2* __restrict__ pairs,
                                           int lo, int hi, int32_t j) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pairs[mid].x <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Pass 2: the tiled output gather, one CTA per (row, tile of kTile).
// kAligned: out is 16-byte aligned and cap % 4 == 0.
template <bool kAligned>
__global__ void __launch_bounds__(kGatherThreads)
gather_tiles_kernel(const int32_t* __restrict__ table,
                    const int32_t* __restrict__ total,
                    const int32_t* __restrict__ arena,
                    int32_t* __restrict__ out, int n, int pool, int cap,
                    int stride, int row, int tiles, int64_t arena_rs) {
  __shared__ __align__(16) int32_t marks[kGatherThreads / 32][kSeg];
  const int64_t r = blockIdx.x / tiles;
  const int j0 = (int)(blockIdx.x - r * tiles) * kTile + threadIdx.x * kVec;
  const int lane = threadIdx.x & 31;
  const int g = j0 / kSeg;  // the warp's segment
  const int segs = (cap + kSeg - 1) / kSeg;
  const int2* pairs = reinterpret_cast<const int2*>(table + r * row);
  const int32_t* seg_first = reinterpret_cast<const int32_t*>(pairs + stride);
  const int32_t* chars = arena + r * arena_rs;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the scan is done
  // independent loads, issued together
  const int32_t tot = total[r];
  const int32_t f0 = seg_first[min(g, segs - 1)];
  const int32_t f1 = seg_first[min(g + 1, segs)];
  const int32_t f_last = seg_first[segs];
  const int lim = min(max(tot, 0), cap);
  int32_t val[kVec] = {0, 0, 0, 0};
  if (g * kSeg < lim) {  // warp-uniform: the segment holds text
    // the runs holding this segment's first output and the next one's
    // (the run holding the row's last output when the next segment holds
    // no text)
    const int lo = min(max(f0, 0), n - 1);
    const int hi = min(max((g + 1) * kSeg < lim ? f1 : f_last, 0), n - 1);
    int run[kVec];
    if (hi - lo < kMarkRuns) {  // warp-uniform
      // each live run after lo marks its first output in the segment; the
      // running max of the marks, from lo, is each output's run
      const int seg0 = g * kSeg;
      int32_t* mk = marks[threadIdx.x >> 5];
      *reinterpret_cast<int4*>(mk + lane * kVec) = make_int4(-1, -1, -1, -1);
      __syncwarp();
      for (int i = lo + 1 + lane; i <= hi; i += 32) {
        const int32_t st = pairs[i].x;
        if (pairs[i + 1].x > st && st >= seg0 && st - seg0 < kSeg)
          mk[st - seg0] = i;
      }
      __syncwarp();
      const int4 m = *reinterpret_cast<const int4*>(mk + lane * kVec);
      run[0] = m.x;
      run[1] = max(run[0], m.y);
      run[2] = max(run[1], m.z);
      run[3] = max(run[2], m.w);
      int32_t x = run[3];  // the running max over the lanes before
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = max(x, y);
      }
      const int32_t before = max(__shfl_up_sync(kFull, x, 1), lo);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        run[k] = lane == 0 ? max(run[k], lo) : max(run[k], before);
    } else {
      // many runs (zero-length ones) in the segment: an upper-bound binary
      // search of the starts for the first output, and from the current
      // run where a later output crosses a run end
      int cur = -1;
      int32_t end = 0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int32_t j = j0 + k;
        if (cur < 0 || j >= end) {
          cur = upper_bound(pairs, cur < 0 ? lo + 1 : cur + 1, hi + 1, j) - 1;
          cur = min(max(cur, lo), hi);
          end = pairs[cur + 1].x;
        }
        run[k] = cur;
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int32_t j = j0 + k;
      const int2 x = pairs[run[k]];
      const int32_t src = (int32_t)((uint32_t)x.y + (uint32_t)(j - x.x));
      if (j < lim) val[k] = chars[min(max(src, 0), pool - 1)];
    }
  }
  int32_t* o = out + r * cap;
  if (kAligned && j0 + kVec <= cap) {
    *reinterpret_cast<int4*>(o + j0) = make_int4(val[0], val[1], val[2],
                                                 val[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (j0 + k < cap) o[j0 + k] = val[k];
}

}  // namespace

extern "C" {

// CTAs of one gather launch at (b, cap): b * ceil(cap / kTile).
long long dt_materialize_runs_ctas(int b, int cap) {
  return (long long)b * (((long long)cap + kTile - 1) / kTile);
}

// int32 words of one row of the scratch table for (n, cap): the (start,
// base) pairs of n + 1 runs, then one run index per segment of kSeg
// outputs and the run of the row's last output, each part a multiple of 4
// words (16-byte aligned rows).
long long dt_materialize_runs_scratch_row(int n, int cap) {
  const long long stride = ((long long)n + 4) / 4 * 4;
  const long long segs = ((long long)cap + kSeg - 1) / kSeg;
  return 2 * stride + (segs + 4) / 4 * 4;
}

// Launch both passes on `stream` (b >= 1, n >= 0, pool >= 1, cap >= 1).
// `table` is the wrapper's scratch: b rows of
// dt_materialize_runs_scratch_row(n, cap) int32, 16-byte aligned. The row
// strides of perm and arena_off are n or 0, arena's pool or 0 (0: one
// shared row). Returns cudaErrorInvalidValue for arguments out of that
// contract or a grid past int32, else the launch's error.
int dt_materialize_runs(const void* perm, const void* vis_len,
                        const void* arena_off, const void* arena, void* out,
                        void* total, void* table, int b, int n, int pool,
                        int cap, long long perm_rs, long long off_rs,
                        long long arena_rs, void* stream) {
  const long long ctas = dt_materialize_runs_ctas(b, cap);
  const long long row = dt_materialize_runs_scratch_row(n, cap);
  if (b < 1 || n < 0 || pool < 1 || cap < 1 || ctas >= (1LL << 31) ||
      row >= (1LL << 31) || cap > 0x7fffffff - kTile ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      (perm_rs != 0 && perm_rs != n) || (off_rs != 0 && off_rs != n) ||
      (arena_rs != 0 && arena_rs != pool))
    return static_cast<int>(cudaErrorInvalidValue);
  const int stride = (n + 4) / 4 * 4;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* tb = static_cast<int32_t*>(table);
  auto* tot = static_cast<int32_t*>(total);
  auto* pm = static_cast<const int32_t*>(perm);
  auto* vl = static_cast<const int32_t*>(vis_len);
  auto* ao = static_cast<const int32_t*>(arena_off);
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(perm) & 15) == 0)
    scan_runs_kernel<true><<<b, kScanThreads, 0, s>>>(
        pm, vl, ao, tb, tot, n, cap, stride, (int)row, perm_rs, off_rs);
  else
    scan_runs_kernel<false><<<b, kScanThreads, 0, s>>>(
        pm, vl, ao, tb, tot, n, cap, stride, (int)row, perm_rs, off_rs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kGatherThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int tiles = (cap + kTile - 1) / kTile;
  auto* ar = static_cast<const int32_t*>(arena);
  auto* o = static_cast<int32_t*>(out);
  if (cap % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0)
    err = cudaLaunchKernelEx(&cfg, gather_tiles_kernel<true>,
                             (const int32_t*)tb, (const int32_t*)tot, ar, o,
                             n, pool, cap, stride, (int)row, tiles,
                             (int64_t)arena_rs);
  else
    err = cudaLaunchKernelEx(&cfg, gather_tiles_kernel<false>,
                             (const int32_t*)tb, (const int32_t*)tot, ar, o,
                             n, pool, cap, stride, (int)row, tiles,
                             (int64_t)arena_rs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
