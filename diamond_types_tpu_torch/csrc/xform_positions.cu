// Transform position resolution (K2): for each document row of doc-order
// visibility columns nv, ov [b, n] int32,
//   pos[i]  = sum(nv[0..i))                      (exclusive prefix sum)
//   new_len = sum(nv)
//   peak    = max(0, max_i sum(nv[0..i] - ov[0..i]))
// all in int32 that wraps, as the JAX package computes them.
//
// Replaces the TPU kernel diamond_types_tpu/tpu/pallas_kernels.py::
// xform_positions_pallas (body _xform_pos_kernel), which runs one document
// per call as a sequential grid over 512-lane chunks carrying
// [base, sum(nv - ov), peak] in SMEM from one grid step to the next; the
// JAX package unrolls the bucket in Python around it.
//
// Design. Blocks run in no order on Hopper, so the carry becomes a loop
// inside the unit that owns a row, and the whole bucket is one launch. The
// unit is ONE WARP per row, kRowsPerCta rows per CTA, with no shared memory
// and no barrier. The warp walks its row in chunks of 32 * kVec elements:
// each lane loads a run of kVec consecutive elements (one 16-byte load
// where the row is aligned), scans them serially in registers, then one
// shuffle scan of the 32 lane totals places every run; the carry and the
// running peak pass from chunk to chunk in registers (the peak reduced
// with shuffles once at the end). pos is stored as the lane's run (16 bytes
// where aligned). Every prefix is formed in unsigned (wrapping)
// arithmetic, element by element, and the peak is the signed maximum of
// those values, so the result equals the plain int32 cumsum even where it
// wraps. The scan is written by hand (no CUB).
//
// What bounds it on an H100 (3.35 TB/s HBM): bytes. Each row's nv and ov
// are read once and pos written once, b*n*3*4 bytes plus 8 bytes per row;
// a few integer operations per element. At the main path's bucket (b 256,
// n 512: 1.57 MB, 0.47 us at HBM rate) the launch itself is most of the
// time, which is why there is no barrier and no shared memory. A very long
// row is walked by its one warp chunk after chunk; the main path's rows are
// a few hundred elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 4;                 // consecutive elements per lane
constexpr int kChunk = 32 * kVec;       // elements per warp step
constexpr int kRowsPerCta = 8;          // rows (warps) per CTA

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One lane's run of a chunk: elements [i0, i0 + kVec) of the row, zero
// past n. kAligned: the row pointers are 16-byte aligned and n % 4 == 0.
template <bool kAligned>
__device__ __forceinline__ void load_run(const int32_t* __restrict__ nvr,
                                         const int32_t* __restrict__ ovr,
                                         int i0, int n, uint32_t (&a)[kVec],
                                         uint32_t (&d)[kVec]) {
  if (kAligned && i0 + kVec <= n) {
    const int4 x = *reinterpret_cast<const int4*>(nvr + i0);
    const int4 y = *reinterpret_cast<const int4*>(ovr + i0);
    a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
    d[0] = a[0] - (uint32_t)y.x; d[1] = a[1] - (uint32_t)y.y;
    d[2] = a[2] - (uint32_t)y.z; d[3] = a[3] - (uint32_t)y.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int i = i0 + e;
    a[e] = i < n ? (uint32_t)nvr[i] : 0u;
    d[e] = i < n ? a[e] - (uint32_t)ovr[i] : 0u;
  }
}

template <bool kAligned>
__device__ __forceinline__ void store_run(int32_t* __restrict__ posr, int i0,
                                          int n, const uint32_t (&p)[kVec]) {
  if (kAligned && i0 + kVec <= n) {
    *reinterpret_cast<int4*>(posr + i0) =
        make_int4((int)p[0], (int)p[1], (int)p[2], (int)p[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    if (i0 + e < n) posr[i0 + e] = (int)p[e];
}

template <bool kAligned>
__global__ void __launch_bounds__(32 * kRowsPerCta)
xform_rows_kernel(const int32_t* __restrict__ nv,
                  const int32_t* __restrict__ ov,
                  int32_t* __restrict__ pos, int32_t* __restrict__ new_len,
                  int32_t* __restrict__ peak_out, int b, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (r >= b) return;  // a whole warp leaves together
  const int32_t* nvr = nv + r * n;
  const int32_t* ovr = ov + r * n;
  int32_t* posr = pos + r * n;
  uint32_t base = 0, cdelta = 0;  // sums of nv and nv - ov before the chunk
  int32_t peak = 0;               // max(0, ...) folded in from the start
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int i0 = c0 + lane * kVec;
    uint32_t a[kVec], d[kVec];
    load_run<kAligned>(nvr, ovr, i0, n, a, d);
    uint32_t ra = 0, rd = 0;  // the run's own sums
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      ra += a[e];
      rd += d[e];
    }
    const uint32_t ia = warp_incl_scan(ra, lane);
    const uint32_t id = warp_incl_scan(rd, lane);
    uint32_t pa = base + ia - ra;    // exclusive prefix of the run's start
    uint32_t pd = cdelta + id - rd;
    uint32_t p[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      p[e] = pa;
      pa += a[e];
      pd += d[e];
      if (i0 + e < n) peak = max(peak, (int32_t)pd);
    }
    store_run<kAligned>(posr, i0, n, p);
    base += __shfl_sync(kFull, ia, 31);
    cdelta += __shfl_sync(kFull, id, 31);
  }
  peak = warp_max(peak);
  if (lane == 0) {
    new_len[r] = (int32_t)base;
    peak_out[r] = peak;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (b >= 1, n >= 0): one warp per row. Rows take 16-byte
// accesses when nv, ov and pos are 16-byte aligned and n % 4 == 0.
// Returns cudaGetLastError() after the launch.
int dt_xform_positions(const void* nv, const void* ov, void* pos,
                       void* new_len, void* peak, int b, int n,
                       void* stream) {
  const bool aligned =
      n % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(nv) | reinterpret_cast<uintptr_t>(ov) |
        reinterpret_cast<uintptr_t>(pos)) & 15) == 0;
  const int grid = (b + kRowsPerCta - 1) / kRowsPerCta;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<const int32_t*>(nv);
  auto* o = static_cast<const int32_t*>(ov);
  auto* p = static_cast<int32_t*>(pos);
  auto* l = static_cast<int32_t*>(new_len);
  auto* k = static_cast<int32_t*>(peak);
  if (aligned)
    xform_rows_kernel<true><<<grid, 32 * kRowsPerCta, 0, s>>>(a, o, p, l, k,
                                                              b, n);
  else
    xform_rows_kernel<false><<<grid, 32 * kRowsPerCta, 0, s>>>(a, o, p, l, k,
                                                               b, n);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
