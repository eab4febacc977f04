// Event identification: exceedance runs, minDuration filter, maxGap
// joining, event starts and slots, split over time.
//
// Replaces the TPU kernel driven by pallas_mhw_filter (xmhw_tpu/ops/
// pallas/rle.py: _call and its six streaming passes _p1_last_false ..
// _p6_end). Same contract as core/events.mhw_filter, bit for bit,
// including day0_fillna_quirk, join_gaps=false, and runs touching day 0 or
// day T-1.
//
// Outputs, by launch: the counting launch writes n_events only; the detect
// launch adds event_day and is_start (one byte each); slot and the
// intermediate event_id/ev_start/ev_end are written only when their
// pointers are non-null. The mode is a template argument.
//
// What bounds it on the H100: device memory traffic. Per (day, cell) it
// reads one byte and writes 0 (count), 2 (days), 6 (slots) or 18 (full)
// bytes: 59.8, 179.5, 418.9 MB per 14,610 x 4,096 block, 0.018 to 0.125
// ms at 3.35 TB/s. Walking all of time in one thread per cell would give
// such a block 128 warps, one per SM: bound by latency, not bandwidth.
//
// Design: a block owns 32 cells, one per lane, and kWarps warps; warp w
// owns days [w L, (w+1) L), L = ceil(T / kWarps), so a 4,096-cell block
// runs 4,096 warps, 32 on each SM. Neighbouring lanes read and write
// neighbouring cells: one 32-byte sector per warp and row. Per block:
//  1. each warp reads its segment once, 32 rows in flight a lane, into bit
//     words (bit j of word k is day a + 32 k + j) in shared memory, or in
//     global scratch when T is too long for shared memory. It walks the
//     runs with find-first-set on the words and records its leading and
//     trailing True counts and the first and last kept day of the runs
//     that lie wholly inside it, whose length it knows;
//  2. warp 0 (lane = cell) walks the segments in order and closes every
//     run that touches a segment edge, however many segments it covers:
//     its global length (less one day for the day-0 quirk) decides whether
//     it is kept, and that sets the edge runs' flags and each segment's
//     first and last kept day; a prefix max and a suffix min give each
//     segment the last kept day before it and the first kept day after it;
//  3. each warp turns its mask words into merged words in place: it clears
//     dropped runs (and day 0 under the quirk) and sets the days of each
//     gap between kept days of at most max_gap days, a gap that straddles
//     an edge included (its far end comes from step 2). After a barrier
//     the warp reads the last merged day of the segment before it and the
//     first of the one after it from their words, so starts
//     (merged & !merged[t-1]) and ends are exact at the edges; it counts
//     its starts (popcount per word). An exclusive prefix over the warps
//     gives slot bases; the sum is n_events. The intermediate output's
//     event start and end of an event open across an edge come from the
//     last start before the segment (prefix max) and the first end after
//     it (suffix min);
//  4. except in the counting launch, each warp writes its days once, from
//     the merged words: no day is written twice.
// Lanes past C read nothing and write nothing but reach every barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // cells per block, one per lane
constexpr int kWarps = 32;  // time segments per block, one per warp
constexpr int kThreads = kLanes * kWarps;
constexpr int kLoadWords = 1;  // bit words loaded at once by a lane
constexpr int kSmemMax = 232448;  // shared memory a block may use (H100)

enum Out { kCount, kDays, kSlots, kFull };

// One cell's segment: what step 1 finds, what step 2 hands back, what
// step 3 counts.
struct Seg {
    int lead, trail;  // leading / trailing True days
    int first, last;  // first / last kept day in the segment (T / -1: none)
    int flags;        // kLeadKept | kTrailKept: the edge runs are kept
    int prev, next;   // last kept day before / first kept day after it
    int starts;       // event starts in the segment
    int last_start;   // last event start in the segment, or -1
    int first_end;    // first event end in the segment, or T
};
constexpr int kLeadKept = 1, kTrailKept = 2;
constexpr int kSegBytes = (int)sizeof(Seg) * kThreads;
// bit words a lane may keep in shared memory beside the Seg array
constexpr int kSmemWords = (kSmemMax - kSegBytes) / (4 * kThreads);

struct Params {
    const uint8_t* bthresh;
    int T, C, L, nw;  // days, cells, segment length, words per segment
    int min_dur, join, max_gap, quirk;
    uint8_t* day;
    uint8_t* st;
    int* slot;
    int* nev;
    int* ev_id;
    int* ev_start;
    int* ev_end;
    uint32_t* scratch;  // null: the bit words live in shared memory
};

// One lane's segment of n days as bit words, kThreads words apart.
struct Bits {
    uint32_t* w;
    int n;

    __device__ __forceinline__ uint32_t& operator[](int k) const {
        return w[(size_t)k * kThreads];
    }

    // the first day >= q that is set (one) or clear (!one), or n
    __device__ int next(int q, bool one) const {
        if (q >= n) return n;
        const int nw = (n + 31) >> 5;
        int k = q >> 5;
        const uint32_t flip = one ? 0u : ~0u;
        uint32_t x = ((*this)[k] ^ flip) & (~0u << (q & 31));
        while (x == 0u) {
            if (++k >= nw) return n;
            x = (*this)[k] ^ flip;
        }
        return min((k << 5) + __ffs(x) - 1, n);
    }

    // set (one) or clear days [lo, hi]
    __device__ void assign(int lo, int hi, bool one) const {
        if (lo > hi) return;
        for (int k = lo >> 5; k <= hi >> 5; ++k) {
            uint32_t m = ~0u;
            if (k == lo >> 5) m &= ~0u << (lo & 31);
            if (k == hi >> 5) m &= ~0u >> (31 - (hi & 31));
            uint32_t& x = (*this)[k];
            x = one ? x | m : x & ~m;
        }
    }
};

// The run of True days [S, E] touches a segment edge: keep or drop it, and
// tell every segment it covers.
__device__ void close_run(const Params& p, Seg* segs, int lane, int S,
                          int E) {
    int ks = S, len = E - S + 1;
    if (p.quirk && S == 0) {  // reference fillna(0) artifact
        ks = 1;
        --len;
    }
    const bool kept = len >= p.min_dur;
    for (int u = S / p.L; u <= E / p.L; ++u) {
        Seg& g = segs[u * kLanes + lane];
        const int au = u * p.L, bu = min(au + p.L, p.T);
        if (kept && S <= au) g.flags |= kLeadKept;
        if (kept && E >= bu - 1) g.flags |= kTrailKept;
        const int lo = max(ks, au), hi = min(E, bu - 1);
        if (kept && lo <= hi) {
            g.first = min(g.first, lo);
            g.last = max(g.last, hi);
        }
    }
}

// Step 2, one lane per cell: close the runs at the edges, then the last
// kept day before and the first kept day after each segment.
__device__ void stitch(const Params& p, Seg* segs, int lane) {
    int rs = -1;  // start of the run open at the current edge
    for (int v = 0; v < kWarps && v * p.L < p.T; ++v) {
        const int a = v * p.L, n = min(p.L, p.T - a);
        const int lead = segs[v * kLanes + lane].lead;
        const int trail = segs[v * kLanes + lane].trail;
        if (lead < n) {
            if (rs >= 0 || lead > 0)
                close_run(p, segs, lane, rs >= 0 ? rs : a, a + lead - 1);
            rs = trail > 0 ? a + n - trail : -1;
        } else if (rs < 0) {
            rs = a;  // a run over the whole segment, open on both sides
        }
    }
    if (rs >= 0) close_run(p, segs, lane, rs, p.T - 1);
    int m = -1;
    for (int v = 0; v < kWarps; ++v) {
        Seg& g = segs[v * kLanes + lane];
        g.prev = m;
        m = max(m, g.last);
    }
    m = p.T;
    for (int v = kWarps - 1; v >= 0; --v) {
        Seg& g = segs[v * kLanes + lane];
        g.next = m;
        m = min(m, g.first);
    }
}

template <int kOut>
__global__ void __launch_bounds__(kThreads)
rle_kernel(Params p) {
    extern __shared__ uint32_t smem_words[];
    __shared__ Seg segs[kThreads];

    const int lane = threadIdx.x % kLanes;
    const int w = threadIdx.x / kLanes;
    const int c = blockIdx.x * kLanes + lane;
    const bool live = c < p.C;
    const int a = min(w * p.L, p.T);
    const int b = min(a + p.L, p.T);
    const int n = b - a;
    const int nw = (n + 31) >> 5;
    uint32_t* col = p.scratch != nullptr
                        ? p.scratch + (size_t)blockIdx.x * p.nw * kThreads
                        : smem_words;
    const Bits bits{col + threadIdx.x, n};
    Seg& me = segs[threadIdx.x];

    // 1. the segment into bit words, kLoadWords words (32 rows each) in
    // flight a lane; edge runs and kept inner runs
    for (int k0 = 0; k0 < nw; k0 += kLoadWords) {
        uint32_t x[kLoadWords];
#pragma unroll
        for (int i = 0; i < kLoadWords; ++i) {
            const int t0 = a + 32 * (k0 + i);
            const int m = live ? min(32, b - t0) : 0;
            const uint8_t* src = p.bthresh + (size_t)t0 * p.C + c;
            x[i] = 0u;
#pragma unroll
            for (int j = 0; j < 32; ++j)
                if (j < m && __ldg(src + (size_t)j * p.C)) x[i] |= 1u << j;
        }
#pragma unroll
        for (int i = 0; i < kLoadWords; ++i)
            if (k0 + i < nw) bits[k0 + i] = x[i];
    }
    int lead = 0, trail = 0, first = p.T, last = -1;
    for (int q = 0;;) {
        const int s = bits.next(q, true);
        if (s >= n) break;
        const int e = bits.next(s, false);  // one past the run
        if (s == 0) lead = e;
        if (e == n) {
            trail = e - s;
        } else if (s > 0 && e - s >= p.min_dur) {
            first = min(first, a + s);
            last = a + e - 1;
        }
        q = e;
    }
    me.lead = lead;
    me.trail = trail;
    me.first = first;
    me.last = last;
    me.flags = 0;
    __syncthreads();

    // 2. runs across the edges
    if (w == 0) stitch(p, segs, lane);
    __syncthreads();

    // 3. mask words -> merged words: drop short runs, join short gaps
    const Seg g = me;
    int pk = g.prev;  // last kept day so far
    for (int q = 0;;) {
        const int s = bits.next(q, true);
        if (s >= n) break;
        const int e = bits.next(s, false);
        const bool kept = s == 0   ? (g.flags & kLeadKept) != 0
                          : e == n ? (g.flags & kTrailKept) != 0
                                   : e - s >= p.min_dur;
        int ks = s;
        if (!kept) {
            bits.assign(s, e - 1, false);
        } else {
            if (p.quirk && a + s == 0) {  // day 0 is never kept
                bits.assign(0, 0, false);
                ks = 1;
            }
            if (ks < e) {
                if (p.join && pk >= 0 && a + ks - pk - 1 <= p.max_gap)
                    bits.assign(max(pk + 1 - a, 0), ks - 1, true);
                pk = a + e - 1;
            }
        }
        q = e;
    }
    if (p.join && pk >= 0 && g.next < p.T && g.next - pk - 1 <= p.max_gap)
        bits.assign(max(pk + 1 - a, 0), n - 1, true);
    __syncthreads();

    // merged on the day before and the day after the segment
    const int lw = (p.L - 1) >> 5;
    const bool before =
        n > 0 && w > 0 &&
        ((bits.w[(size_t)lw * kThreads - kLanes] >> ((p.L - 1) & 31)) & 1u);
    const bool after = b < p.T && (bits.w[kLanes] & 1u);
    uint32_t cin = before;
    int starts = 0, last_start = -1, first_end = p.T;
    for (int k = 0; k < nw; ++k) {
        const uint32_t x = bits[k];
        const uint32_t s = x & ~((x << 1) | cin);
        cin = x >> 31;
        starts += __popc(s);
        if (kOut == kFull) {
            if (s) last_start = a + 32 * k + 31 - __clz(s);
            uint32_t nx = k + 1 < nw ? (bits[k + 1] & 1u) << 31 : 0u;
            if (k == nw - 1) nx |= (uint32_t)after << ((n - 1) & 31);
            const uint32_t e = x & ~((x >> 1) | nx);
            if (e && first_end == p.T) first_end = a + 32 * k + __ffs(e) - 1;
        }
    }
    me.starts = starts;
    me.last_start = last_start;
    me.first_end = first_end;
    __syncthreads();
    int base = 0, total = 0, cur_start = -1, end_after = p.T;
    for (int v = 0; v < kWarps; ++v) {
        const Seg& o = segs[v * kLanes + lane];
        total += o.starts;
        if (v < w) {
            base += o.starts;
            cur_start = max(cur_start, o.last_start);
        }
        if (v > w) end_after = min(end_after, o.first_end);
    }
    if (w == 0 && live) p.nev[c] = total;
    if (kOut == kCount || !live) return;

    // 4. write each day once
    int cur_end = -1;
    auto end_of = [&](int t) {  // the last day of the merged run at t
        const int e = bits.next(t, false);
        return e < n || !after ? a + e - 1 : end_after;
    };
    if (kOut == kFull && before && n > 0 && (bits[0] & 1u)) cur_end = end_of(0);
    cin = before;
    int cnt = base;  // starts up to the current day
    for (int k = 0; k < nw; ++k) {
        const uint32_t x = bits[k];
        const uint32_t s = x & ~((x << 1) | cin);
        cin = x >> 31;
        const int t0 = a + 32 * k;
        const int m = min(32, b - t0);
        size_t o = (size_t)t0 * p.C + c;
#pragma unroll 4
        for (int j = 0; j < m; ++j, o += p.C) {
            const uint32_t d = (x >> j) & 1u, st = (s >> j) & 1u;
            p.day[o] = (uint8_t)d;
            p.st[o] = (uint8_t)st;
            if (kOut >= kSlots) {
                cnt += st;
                p.slot[o] = cnt - 1;
            }
            if (kOut == kFull) {
                if (st) {
                    cur_start = t0 + j;
                    cur_end = end_of(32 * k + j);
                }
                p.ev_id[o] = d ? cur_start : -1;
                p.ev_start[o] = d ? cur_start : -1;
                p.ev_end[o] = d ? cur_end : -1;
            }
        }
    }
}

int segment_len(int T) { return (T + kWarps - 1) / kWarps; }
int segment_words(int T) { return (segment_len(T) + 31) / 32; }

template <int kOut>
int launch(const Params& p, cudaStream_t stream) {
    const int smem = p.scratch != nullptr ? 0 : p.nw * 4 * kThreads;
    cudaError_t e = cudaFuncSetAttribute(
        rle_kernel<kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (p.C + kLanes - 1) / kLanes;
    rle_kernel<kOut><<<blocks, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// uint32 words of scratch that xmhw_rle needs for T days and C cells: 0
// when a segment's bit words fit in shared memory (T up to 47,104 days).
extern "C" long long xmhw_rle_scratch(int T, int C) {
    const int nw = segment_words(T);
    if (nw <= kSmemWords) return 0;
    return (long long)((C + kLanes - 1) / kLanes) * nw * kThreads;
}

// bthresh: (T, C) uint8 0/1; nev: (C,) int32. day, st: (T, C) uint8 0/1,
// both null for the counting launch; slot: (T, C) int32 or null;
// ev_id/ev_start/ev_end: (T, C) int32, all three null or none (then slot
// too is given). scratch: xmhw_rle_scratch(T, C) words, or null when that
// is 0.
extern "C" int xmhw_rle(const uint8_t* bthresh, int T, int C, int min_dur,
                        int join, int max_gap, int quirk, uint8_t* day,
                        uint8_t* st, int* slot, int* nev, int* ev_id,
                        int* ev_start, int* ev_end, uint32_t* scratch,
                        void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (C == 0) return 0;
    if (T == 0) return (int)cudaMemsetAsync(nev, 0, sizeof(int) * C, s);
    Params p{bthresh, T,   C,    segment_len(T), segment_words(T),
             min_dur, join, max_gap, quirk,      day,
             st,      slot, nev,  ev_id,          ev_start,
             ev_end,  scratch};
    if (day == nullptr) return launch<kCount>(p, s);
    if (slot == nullptr) return launch<kDays>(p, s);
    if (ev_id == nullptr) return launch<kSlots>(p, s);
    return launch<kFull>(p, s);
}

// The launch shape for T days: time segments (warps) per block, threads
// per block, days per segment and shared memory bytes per block (static
// and dynamic).
extern "C" void xmhw_rle_config(int T, int* warps, int* threads, int* days,
                                int* smem_bytes) {
    *warps = kWarps;
    *threads = kThreads;
    *days = segment_len(T);
    *smem_bytes = kSegBytes + (xmhw_rle_scratch(T, 1) > 0
                                   ? 0
                                   : segment_words(T) * 4 * kThreads);
}
