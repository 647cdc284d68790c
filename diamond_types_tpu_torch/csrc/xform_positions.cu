// Transform position resolution (K2): for each document row of doc-order
// visibility columns nv, ov [b, n] int32,
//   pos[i]  = sum(nv[0..i))                      (exclusive prefix sum)
//   new_len = sum(nv)
//   peak    = max(0, max_i sum(nv[0..i] - ov[0..i]))
// all in int32, as the JAX package computes them.
//
// Replaces the TPU kernel diamond_types_tpu/tpu/pallas_kernels.py::
// xform_positions_pallas (body _xform_pos_kernel), which runs one document
// per call as a sequential grid over 512-lane chunks carrying
// [base, sum(nv - ov), peak] in SMEM from one grid step to the next; the
// JAX package unrolls the bucket in Python around it.
//
// Design. Blocks run in no order on Hopper, so the carry becomes a loop
// inside one CTA per document row, and the whole bucket is one launch. The
// CTA walks its row in tiles of kThreads elements: each warp does an
// inclusive shuffle scan of nv and of nv - ov, every warp then scans the
// 32 warp totals from shared memory itself (no third barrier), and the
// carried base is added. pos = base + incl - nv is written; the running
// maximum of cdelta + incl_d is reduced per tile. Thread 0 writes new_len
// and max(peak, 0). The scan is written by hand (no CUB).
//
// What bounds it on an H100 (3.35 TB/s HBM): bytes. Each row's nv and ov
// are read once and pos written once, b*n*3*4 bytes plus 8 bytes per row;
// the arithmetic is a few integer operations per element. Reads and writes
// are coalesced (consecutive threads on consecutive elements); a row is
// one CTA, so a bucket narrower than the SM count leaves SMs idle, which
// only a split of long rows across CTAs (a later change) would fix.

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

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
xform_positions_kernel(const int32_t* __restrict__ nv,
                       const int32_t* __restrict__ ov,
                       int32_t* __restrict__ pos,
                       int32_t* __restrict__ new_len,
                       int32_t* __restrict__ peak_out, int n) {
  __shared__ int32_t tot_nv[kWarps];
  __shared__ int32_t tot_d[kWarps];
  __shared__ int32_t tile_max[kWarps];
  const int64_t r = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int32_t* nvr = nv + r * n;
  const int32_t* ovr = ov + r * n;
  int32_t* posr = pos + r * n;

  // identical in every thread
  int32_t base = 0, cdelta = 0, peak = 0;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + t;
    int32_t a = 0, d = 0;
    if (i < n) {
      a = nvr[i];
      d = a - ovr[i];
    }
    const int32_t sa = warp_incl_scan(a, lane);
    const int32_t sd = warp_incl_scan(d, lane);
    if (lane == 31) {
      tot_nv[w] = sa;
      tot_d[w] = sd;
    }
    __syncthreads();
    // every warp scans the warp totals itself
    const int32_t ta = tot_nv[lane];
    const int32_t td = tot_d[lane];
    const int32_t ia = warp_incl_scan(ta, lane);
    const int32_t id = warp_incl_scan(td, lane);
    const int32_t off_a = __shfl_sync(kFull, ia - ta, w);
    const int32_t off_d = __shfl_sync(kFull, id - td, w);
    const int32_t tile_a = __shfl_sync(kFull, ia, 31);
    const int32_t tile_d = __shfl_sync(kFull, id, 31);
    const int32_t incl_a = sa + off_a;
    const int32_t incl_d = sd + off_d;
    if (i < n) posr[i] = base + incl_a - a;
    const int32_t m = warp_max(i < n ? incl_d : INT32_MIN);
    if (lane == 0) tile_max[w] = m;
    __syncthreads();
    const int32_t tm = warp_max(tile_max[lane]);
    peak = max(peak, cdelta + tm);  // i0 < n: the tile has an element
    base += tile_a;
    cdelta += tile_d;
  }
  if (t == 0) {
    new_len[r] = base;
    peak_out[r] = max(peak, 0);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: one CTA per row. Returns cudaGetLastError().
int dt_xform_positions(const void* nv, const void* ov, void* pos,
                       void* new_len, void* peak, int b, int n,
                       void* stream) {
  xform_positions_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nv), static_cast<const int32_t*>(ov),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(new_len),
      static_cast<int32_t*>(peak), n);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
