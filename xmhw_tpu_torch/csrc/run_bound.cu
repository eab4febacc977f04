// Running True-index bound of a (T, C) mask along time:
//   forward:  out[t] = max { s <= t : mask[s] }   (-1 if none)
//   backward: out[t] = min { s >= t : mask[s] }   (T if none)
//
// Replaces the TPU kernel xmhw_tpu/ops/pallas/run_bound.py:run_bound
// (_fwd_kernel/_bwd_kernel): the primitive every scan of the event RLE is
// an instance of (last_false = fwd(~bthresh), next_false = bwd(~bthresh)).
//
// What bounds it on the H100: device memory traffic, one byte read and
// four bytes written per (day, cell), about 0.3 GB per 14,610 x 4,096
// block; and, with one thread per cell, memory latency (a 4,096-cell
// block is 128 warps).
//
// Design: not the TPU's Hillis-Steele log-shift over 1,024-row VMEM tiles
// with a carry row between grid steps. One thread per cell walks time in
// its direction and carries the bound in a register; neighbouring threads
// hold neighbouring cells, so each time row is one coalesced read and one
// coalesced write. 32 rows are loaded into a bit mask before they are
// used, so 32 loads are in flight per thread. Any C: the ragged edge is
// masked, no 128-lane padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 32;  // rows per batched load (one bit each)

__global__ void run_bound_kernel(const uint8_t* __restrict__ mask, int T,
                                 int C, int forward, int* __restrict__ out) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= C) return;
    int bound = forward ? -1 : T;
    for (int k0 = 0; k0 < T; k0 += kChunk) {
        const int n = min(kChunk, T - k0);
        // row of the j-th step of this chunk, in walking order
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
            const int t = forward ? k0 + j : T - 1 - k0 - j;
            if (j < n && __ldg(mask + (size_t)t * C + c)) m |= 1u << j;
        }
        for (int j = 0; j < n; ++j) {
            const int t = forward ? k0 + j : T - 1 - k0 - j;
            if ((m >> j) & 1u) bound = t;
            out[(size_t)t * C + c] = bound;
        }
    }
}

}  // namespace

// mask: (T, C) uint8 0/1, contiguous; out: (T, C) int32.
extern "C" int xmhw_run_bound(const uint8_t* mask, int T, int C, int forward,
                              int* out, void* stream) {
    if (T > 0 && C > 0) {
        const int blocks = (C + kThreads - 1) / kThreads;
        run_bound_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            mask, T, C, forward, out);
    }
    return (int)cudaGetLastError();
}
