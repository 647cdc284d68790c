// Fused window replay: a whole [b, n] op tape applied to [b, cap] document
// rows in ONE launch.
//
// Replaces the TPU kernel diamond_types_tpu/tpu/pallas_kernels.py::
// apply_op_block (body _apply_op_rows_kernel), which applies ONE op per row
// and is launched n times per window inside a lax.scan
// (tpu/flush_fuse.py::make_pallas_replay_body). This kernel computes that
// whole window function:
//   1. ops with dlen > max_ins or ilen > max_ins are zeroed to no-ops;
//   2. the n ops are applied in order, each as
//        out[i] = doc[i]                          for i < pos
//               = chars[i - pos]                  for pos <= i < pos + ilen
//               = doc[(i - ilen + dlen) mod cap]  otherwise (a roll: wraps)
//      and a no-op when ilen == dlen == 0;
//   3. len += ilen - dlen per applied op (int32, wrapping), and a row with
//      any out-of-contract op returns length -1 (a row that comes in at -1
//      with all-zero ops stays at -1). Out of contract also means a
//      negative pos, dlen or ilen, which the planner never emits.
//
// Design. One CTA per document row; the op tape loops inside the kernel.
// The row lives in dynamic shared memory when it fits (cap * 4 bytes plus
// the small op-tile and wrap buffers, within the 227 KB a block may use;
// caps up to 32768), else in its own row of the output tensor in device
// memory. Either way each op is an in-place memmove of the tail
// [pos + ilen, cap) by shift = ilen - dlen:
//   * shift > 0 moves right: chunks of kChunk elements from the top down,
//     each read into registers, __syncthreads(), written back. No source
//     wraps (sources lie in [pos + dlen, cap - shift)).
//   * shift < 0 moves left: the first -shift elements (the wrap-around
//     sources of the roll) are saved first, then chunks from the bottom up.
// A chunk's writes never overlap the next chunk's reads, so one barrier per
// chunk suffices. The insert lane [pos, pos + ilen) is written last from
// the op's chars, then a barrier closes the op. Requires max_ins <= cap
// (the wrapper checks it): a left shift then wraps at most once.
//
// What bounds it on an H100 (3.35 TB/s HBM): device memory sees each row
// read once and written once plus the op tape, 2*b*cap*4 + b*n*(3+mi)*4
// bytes. The work per op moves about (cap - pos) elements of the row, n
// times per row, in shared memory (or in L1/L2 for rows that do not fit),
// so with short tapes the kernel is near its HBM bound and with long tapes
// it is bound by shared-memory traffic and the per-op barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;   // threads per CTA (one CTA per row)
constexpr int kPerThread = 4;    // row elements each thread stages per chunk
constexpr int kChunk = kThreads * kPerThread;
constexpr int kOpTile = 256;     // ops whose scalars are staged in smem at once

// Smem layout (ints): [op tile: 3 * kOpTile][wrap buffer: max_ins][row: cap]
template <bool kRowInSmem>
__global__ void __launch_bounds__(kThreads)
apply_ops_window_kernel(const int32_t* __restrict__ docs,
                        const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ pos,
                        const int32_t* __restrict__ dlen,
                        const int32_t* __restrict__ ilen,
                        const int32_t* __restrict__ chars,
                        int32_t* __restrict__ out_docs,
                        int32_t* __restrict__ out_lens,
                        int n, int cap, int mi) {
  extern __shared__ int32_t smem[];
  int32_t* op_pos = smem;
  int32_t* op_dl = smem + kOpTile;
  int32_t* op_il = smem + 2 * kOpTile;
  int32_t* wrap = smem + 3 * kOpTile;
  const int64_t r = blockIdx.x;
  const int t = threadIdx.x;
  int32_t* row = kRowInSmem ? (wrap + mi) : (out_docs + r * cap);

  const int32_t* src_row = docs + r * cap;
  for (int i = t; i < cap; i += kThreads) row[i] = src_row[i];

  int32_t len = lens[r];
  bool bad_doc = false;
  const int32_t* tape_pos = pos + r * n;
  const int32_t* tape_dl = dlen + r * n;
  const int32_t* tape_il = ilen + r * n;
  const int32_t* tape_ch = chars + r * (int64_t)n * mi;

  for (int k0 = 0; k0 < n; k0 += kOpTile) {
    const int m = min(kOpTile, n - k0);
    __syncthreads();  // the previous tile's scalars are no longer read
    for (int j = t; j < m; j += kThreads) {
      op_pos[j] = tape_pos[k0 + j];
      op_dl[j] = tape_dl[k0 + j];
      op_il[j] = tape_il[k0 + j];
    }
    __syncthreads();  // also orders the row's initial copy before op 0
    for (int j = 0; j < m; ++j) {
      const int p = op_pos[j];
      const int dl = op_dl[j];
      const int il = op_il[j];
      // out of contract: a no-op that poisons the row. Negative fields
      // are out of contract too (the planner never emits them), which
      // keeps every index below inside the row and the wrap buffer.
      if (dl > mi || il > mi || dl < 0 || il < 0 || p < 0) {
        bad_doc = true;
        continue;
      }
      if (dl == 0 && il == 0) continue;
      len = static_cast<int32_t>(static_cast<uint32_t>(len) +
                                 static_cast<uint32_t>(il - dl));
      if (p >= cap) continue;  // every i < pos: the row is unchanged
      const int shift = il - dl;
      const int r0 = p + il;   // first tail index
      if (shift > 0 && r0 < cap) {
        for (int hi = cap; hi > r0; hi -= kChunk) {
          const int lo = max(r0, hi - kChunk);
          int32_t v[kPerThread];
#pragma unroll
          for (int q = 0; q < kPerThread; ++q) {
            const int i = lo + t + q * kThreads;
            if (i < hi) v[q] = row[i - shift];
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kPerThread; ++q) {
            const int i = lo + t + q * kThreads;
            if (i < hi) row[i] = v[q];
          }
        }
      } else if (shift < 0 && r0 < cap) {
        const int d = -shift;  // d <= max_ins <= cap
        for (int i = t; i < d; i += kThreads) wrap[i] = row[i];
        __syncthreads();
        for (int lo = r0; lo < cap; lo += kChunk) {
          const int hi = min(cap, lo + kChunk);
          int32_t v[kPerThread];
#pragma unroll
          for (int q = 0; q < kPerThread; ++q) {
            const int i = lo + t + q * kThreads;
            if (i < hi) v[q] = (i + d < cap) ? row[i + d] : wrap[i + d - cap];
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kPerThread; ++q) {
            const int i = lo + t + q * kThreads;
            if (i < hi) row[i] = v[q];
          }
        }
      }
      // The insert lane [p, r0) is disjoint from the tail's writes, and
      // every tail read of it happened before the last chunk's barrier.
      const int32_t* c = tape_ch + (int64_t)(k0 + j) * mi;
      for (int q = t; q < il && p + q < cap; q += kThreads) row[p + q] = c[q];
      __syncthreads();
    }
  }
  if (kRowInSmem) {
    int32_t* dst = out_docs + r * cap;
    for (int i = t; i < cap; i += kThreads) dst[i] = row[i];
  }
  if (t == 0) out_lens[r] = bad_doc ? -1 : len;
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel asks for at (cap, max_ins); the row
// itself counts only when it sits in shared memory.
int dt_apply_ops_window_smem_bytes(int cap, int mi, int row_in_smem) {
  return (3 * kOpTile + mi + (row_in_smem ? cap : 0)) * 4;
}

// Launch on `stream`. Returns cudaGetLastError() after the launch (or the
// error of the attribute call that would let the launch use its shared
// memory), so a refused launch is reported to the caller.
int dt_apply_ops_window(const void* docs, const void* lens, const void* pos,
                        const void* dlen, const void* ilen, const void* chars,
                        void* out_docs, void* out_lens, int b, int n, int cap,
                        int mi, int row_in_smem, void* stream) {
  const int smem = dt_apply_ops_window_smem_bytes(cap, mi, row_in_smem);
  auto* kernel = row_in_smem ? apply_ops_window_kernel<true>
                             : apply_ops_window_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(docs), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(dlen),
      static_cast<const int32_t*>(ilen), static_cast<const int32_t*>(chars),
      static_cast<int32_t*>(out_docs), static_cast<int32_t*>(out_lens), n,
      cap, mi);
  return static_cast<int>(cudaGetLastError());
}

const char* dt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
