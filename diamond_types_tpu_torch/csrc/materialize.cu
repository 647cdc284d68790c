// Device checkout's text assembly (K3): for each document row, lay the
// runs out in document order,
//   vl[i]    = vis_len[perm[i]]
//   start[i] = sum(vl[0..i))                       (exclusive prefix sum)
//   out[start[i] + k] = arena[clamp(arena_off[perm[i]] + k, 0, pool - 1)]
//                     for 0 <= k < vl[i] and start[i] + k < cap
//   out[j] = 0 for min(total, cap) <= j < cap,    total = sum(vl) (unclipped)
// on perm, vis_len, arena_off [b, n] int32 and arena [b, pool] int32. It is
// the function of the JAX package's materialize_jax on in-contract input
// (vis_len >= 0, perm a permutation of each row's n runs).
//
// Replaces the TPU kernel diamond_types_tpu/tpu/pallas_kernels.py::
// materialize_pallas (body _materialize_runs_kernel): a sequential grid of
// one step per run over run tables held in SMEM, which bounds them at
// 8,192 runs and falls back to XLA past that, one document per call.
//
// Design. One CTA per document row, the whole batch in one launch.
//   1. A block scan of vl[perm] (warp shuffle scans, warp totals through
//      shared memory, a carried base across tiles of kThreads runs) writes
//      each run's start into start[0..n], start[n] = total. The starts live
//      in dynamic shared memory when (n + 1) * 4 bytes fit a block's
//      227 KB, else in a scratch row of device memory that the wrapper
//      allocates; no run bound either way.
//   2. Warps take runs round-robin. A warp copies its run with the 32
//      lanes on neighbouring addresses of the arena and of the output; a
//      run that starts at or past cap writes nothing.
//   3. All threads zero [min(total, cap), cap).
// perm is clamped to [0, n) before it indexes, so no input reads out of
// bounds.
//
// What bounds it on an H100 (3.35 TB/s HBM): bytes. The run tables are read
// once (b*n*3*4), the visible text once (b*min(total, cap)*4) and the output
// written once (b*cap*4). Runs of a few chars leave most of a warp's lanes
// idle, and the gathers through perm are scattered 4-byte reads, so short
// runs make it latency-bound well before it reaches that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t warp_incl_scan(int32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t x = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

template <bool kStartsInSmem>
__global__ void __launch_bounds__(kThreads)
materialize_runs_kernel(const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ vis_len,
                        const int32_t* __restrict__ arena_off,
                        const int32_t* __restrict__ arena,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ total_out,
                        int32_t* __restrict__ starts_scratch, int n,
                        int pool, int cap) {
  extern __shared__ int32_t smem_starts[];
  __shared__ int32_t warp_tot[kWarps];
  const int64_t r = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int32_t* pr = perm + r * n;
  const int32_t* vr = vis_len + r * n;
  const int32_t* ar = arena_off + r * n;
  const int32_t* chars = arena + r * pool;
  int32_t* o = out + r * cap;
  int32_t* starts = kStartsInSmem ? smem_starts
                                  : starts_scratch + r * (int64_t)(n + 1);

  // 1. starts = exclusive scan of vl[perm]
  int32_t base = 0;  // identical in every thread
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + t;
    int32_t v = 0;
    if (i < n) v = vr[min(max(pr[i], 0), n - 1)];
    const int32_t s = warp_incl_scan(v, lane);
    if (lane == 31) warp_tot[w] = s;
    __syncthreads();
    const int32_t tw = warp_tot[lane];
    const int32_t iw = warp_incl_scan(tw, lane);
    const int32_t off = __shfl_sync(kFull, iw - tw, w);
    const int32_t tile = __shfl_sync(kFull, iw, 31);
    if (i < n) starts[i] = base + s + off - v;
    base += tile;
    __syncthreads();  // warp_tot is rewritten by the next tile
  }
  if (t == 0) {
    starts[n] = base;
    total_out[r] = base;
  }
  __syncthreads();  // every start visible to the block (shared or global)

  // 2. one warp per run, round-robin
  for (int i = w; i < n; i += kWarps) {
    const int32_t s = starts[i];
    if (s >= cap) continue;
    const int32_t len = min(starts[i + 1] - s, cap - s);
    if (len <= 0) continue;
    const int32_t src = ar[min(max(pr[i], 0), n - 1)];
    for (int k = lane; k < len; k += 32) {
      o[s + k] = chars[min(max(src + k, 0), pool - 1)];
    }
  }

  // 3. zero past the text
  for (int j = min(max(base, 0), cap) + t; j < cap; j += kThreads) o[j] = 0;
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes the kernel asks for when the starts live in
// shared memory.
int dt_materialize_runs_smem_bytes(int n) { return (n + 1) * 4; }

// Launch on `stream`: one CTA per row. `starts_scratch` ([b, n + 1] int32)
// is read only when starts_in_smem is 0. Returns cudaGetLastError() after
// the launch, or the error of the attribute call that lets it use its
// shared memory.
int dt_materialize_runs(const void* perm, const void* vis_len,
                        const void* arena_off, const void* arena, void* out,
                        void* total, void* starts_scratch, int b, int n,
                        int pool, int cap, int starts_in_smem, void* stream) {
  const int smem = starts_in_smem ? dt_materialize_runs_smem_bytes(n) : 0;
  auto* kernel = starts_in_smem ? materialize_runs_kernel<true>
                                : materialize_runs_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(vis_len),
      static_cast<const int32_t*>(arena_off),
      static_cast<const int32_t*>(arena), static_cast<int32_t*>(out),
      static_cast<int32_t*>(total), static_cast<int32_t*>(starts_scratch), n,
      pool, cap);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
