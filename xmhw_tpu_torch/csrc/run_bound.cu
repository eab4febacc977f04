// Running True-index bound of a (T, C) mask along time:
//   forward:  out[t] = max { s <= t : mask[s] }   (-1 if none)
//   backward: out[t] = min { s >= t : mask[s] }   (T if none)
//
// Replaces the TPU kernel xmhw_tpu/ops/pallas/run_bound.py:run_bound
// (_fwd_kernel/_bwd_kernel): the primitive every scan of the event RLE is
// an instance of (last_false = fwd(~bthresh), next_false = bwd(~bthresh)).
// The TPU kernel is a Hillis-Steele log-shift over 1,024-row VMEM tiles
// with a carry row between grid steps; nothing of that order survives on a
// GPU, where blocks run in parallel.
//
// What bounds it on the H100: device memory traffic, one byte read and
// four bytes written per (day, cell): 299 MB per direction at 14,610 x
// 4,096, 0.089 ms at 3.35 TB/s, of which the int32 writes are 239 MB.
// One thread per cell walking all of time (the first design) gives such a
// block 128 warps, one per SM: bound by latency, not bandwidth.
//
// Design: a block owns 32 cells, one per lane, and kWarps warps; warp w
// owns days [w L, (w+1) L), L = ceil(T / kWarps), so a 4,096-cell block
// runs 4,096 warps. A day's bound lies inside its segment from the
// segment's first True day on (forward; backward: up to its last True
// day), and only the days before it (after it) need the carry from the
// other segments. Per block:
//  1. each warp walks its segment once in the scan's direction, 32 rows in
//     flight a lane (one 32-byte sector a warp and row) and the next 32
//     loaded while the current ones are written; it writes every day whose
//     bound lies in the segment (one 128-byte line a warp and row) and
//     records the segment's last True day (forward) or first (backward),
//     so reads and writes overlap;
//  2. one barrier; a warp's carry is the maximum over the earlier
//     segments' last True days (forward), or the minimum over the later
//     segments' first True days (backward): at most kWarps values a lane;
//  3. each warp writes the carry to the days of its segment before its
//     first True day (forward; backward: after its last), which hold no
//     True day: no read.
// Every day is written once. No shared memory but the segment bounds, so
// any T. Lanes past C read and write nothing but reach the barrier. Any
// C: the ragged edge is masked, no 128-lane padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // cells per block, one per lane
constexpr int kWarps = 32;  // time segments per block, one per warp
constexpr int kThreads = kLanes * kWarps;

struct Params {
    const uint8_t* mask;
    int T, C, L;  // days, cells, segment length
    int* out;
};

int segment_len(int T) { return (T + kWarps - 1) / kWarps; }

// m <= 32 rows of cell c from day t0 as a bit word (bit j: day t0 + j),
// the 32 loads in flight at once
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ src,
                                              int C, int m) {
    uint32_t x = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j)
        if (j < m && __ldg(src + (size_t)j * C)) x |= 1u << j;
    return x;
}

// A day's bound, stored with evict-first: no output line is read again.
__device__ __forceinline__ void put(int* p, int v) { __stcs(p, v); }

// Step 1 for one word of m days from t0, walked in the scan's direction:
// the running bound (``none`` until the segment's first True day in that
// direction) is written to every day that has one.
template <bool kForward>
__device__ __forceinline__ void write_word(int* __restrict__ dst, int C,
                                           int t0, int m, uint32_t x,
                                           int none, int& bound) {
    if (m == 32) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int j = kForward ? i : 31 - i;
            if ((x >> j) & 1u) bound = t0 + j;
            if (bound != none) put(dst + (size_t)j * C, bound);
        }
        return;
    }
    for (int i = 0; i < m; ++i) {
        const int j = kForward ? i : m - 1 - i;
        if ((x >> j) & 1u) bound = t0 + j;
        if (bound != none) put(dst + (size_t)j * C, bound);
    }
}

template <bool kForward>
__global__ void __launch_bounds__(kThreads) run_bound_kernel(Params p) {
    __shared__ int seg[kThreads];  // [warp][lane]: the segment's bound

    const int lane = threadIdx.x % kLanes;
    const int w = threadIdx.x / kLanes;
    const int c = blockIdx.x * kLanes + lane;
    const bool live = c < p.C;
    const int a = min(w * p.L, p.T);
    const int b = min(a + p.L, p.T);
    const int nw = (b - a + 31) >> 5;
    const int none = kForward ? -1 : p.T;
    const uint8_t* __restrict__ col = p.mask + c;
    int* __restrict__ out = p.out + c;

    // 1. walk the segment: the words in the scan's direction, the next
    // one loaded before the current one is written
    int bound = none;
    int edge = none;  // the first True day met: where the writes began
    if (live && nw > 0) {
        auto t0_of = [&](int i) {
            return a + 32 * (kForward ? i : nw - 1 - i);
        };
        int t0 = t0_of(0);
        uint32_t x = load_word(col + (size_t)t0 * p.C, p.C, min(32, b - t0));
        for (int i = 0; i < nw; ++i) {
            const int t1 = i + 1 < nw ? t0_of(i + 1) : t0;
            const uint32_t y = i + 1 < nw
                ? load_word(col + (size_t)t1 * p.C, p.C, min(32, b - t1))
                : 0u;
            if (bound == none && x != 0u)
                edge = kForward ? t0 + __ffs(x) - 1 : t0 + 31 - __clz(x);
            write_word<kForward>(out + (size_t)t0 * p.C, p.C, t0,
                                 min(32, b - t0), x, none, bound);
            t0 = t1;
            x = y;
        }
    }
    seg[threadIdx.x] = bound;  // last (forward) / first (backward) True day
    __syncthreads();

    // 2. the carry into the segment
    int carry = none;
    if (kForward) {
        for (int v = 0; v < w; ++v)
            carry = max(carry, seg[v * kLanes + lane]);
    } else {
        for (int v = w + 1; v < kWarps; ++v)
            carry = min(carry, seg[v * kLanes + lane]);
    }
    if (!live) return;

    // 3. the days before the segment's first True day (forward) or after
    // its last (backward), all of it without one
    const int lo = kForward || edge == none ? a : edge + 1;
    const int hi = !kForward || edge == none ? b : edge;
    for (int t = lo; t < hi; ++t) put(out + (size_t)t * p.C, carry);
}

template <bool kForward>
int launch(const Params& p, cudaStream_t stream) {
    const int blocks = (p.C + kLanes - 1) / kLanes;
    run_bound_kernel<kForward><<<blocks, kThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// mask: (T, C) uint8 0/1, contiguous; out: (T, C) int32.
extern "C" int xmhw_run_bound(const uint8_t* mask, int T, int C, int forward,
                              int* out, void* stream) {
    if (T <= 0 || C <= 0) return 0;
    const Params p{mask, T, C, segment_len(T), out};
    const cudaStream_t s = (cudaStream_t)stream;
    return forward ? launch<true>(p, s) : launch<false>(p, s);
}

// The launch shape for T days: time segments (warps) per block, threads
// per block, days per segment and shared memory bytes per block.
extern "C" void xmhw_run_bound_config(int T, int* warps, int* threads,
                                      int* days, int* smem_bytes) {
    *warps = kWarps;
    *threads = kThreads;
    *days = segment_len(T);
    *smem_bytes = 4 * kThreads;
}
