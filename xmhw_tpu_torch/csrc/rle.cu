// Event identification: exceedance runs, minDuration filter, maxGap
// joining, event starts and slots.
//
// Replaces the TPU kernel driven by pallas_mhw_filter (xmhw_tpu/ops/
// pallas/rle.py: _call and its six streaming passes _p1_last_false ..
// _p6_end). Same contract as core/events.mhw_filter, bit for bit,
// including day0_fillna_quirk, join_gaps=false, and runs touching day 0 or
// day T-1.
//
// What bounds it on the H100: device memory traffic and, at a few
// thousand cells, memory latency. Per (day, cell) it reads one byte and
// writes event_day, is_start and slot (6 bytes; 18 with the intermediate
// arrays), about 0.4 GB per 14,610 x 4,096 block. With one thread per
// cell, a 4,096-cell block is only 128 warps, so a sequential walk that
// waited on each load would be latency bound.
//
// Design: one thread per cell walks time forward once. A run of True days
// is closed on its first False day; the run is kept when long enough, and
// then either extends the open merged event (gap <= max_gap) or opens a
// new one. Every day is first written as a non-event day; the days of a
// kept run and of a joined gap are rewritten once the run has closed (the
// same thread writes both, so program order keeps them right; the
// rewrites touch only event days, ~10% of all). A second forward walk
// turns is_start into slot = cumsum - 1 and n_events. Loads are batched:
// 32 rows are fetched into a bit mask before they are used, so 32 loads
// are in flight per thread. event_id/ev_start/ev_end are written only
// when their pointers are non-null (the intermediate output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 32;  // rows per batched load (one bit each)

struct Params {
    int T, C, c, min_dur, join, max_gap, quirk;
    uint8_t* day;
    uint8_t* st;
    int* ev_id;
    int* ev_start;
    int* ev_end;
};

__device__ __forceinline__ size_t at(const Params& p, int t) {
    return (size_t)t * p.C + p.c;
}

__device__ void write_event(const Params& p, int ms, int me) {
    if (p.ev_id == nullptr) return;
    for (int u = ms; u <= me; ++u) {
        p.ev_id[at(p, u)] = ms;
        p.ev_start[at(p, u)] = ms;
        p.ev_end[at(p, u)] = me;
    }
}

// run of True days [a, e] has closed: keep it, join it or drop it
__device__ void close_run(const Params& p, int a, int e, int& ms, int& me) {
    int len = e - a + 1;
    if (p.quirk && a == 0) {  // reference fillna(0) artifact
        a = 1;
        --len;
    }
    if (len < p.min_dur || a > e) return;
    if (ms >= 0 && p.join && a - me - 1 <= p.max_gap) {
        for (int u = me + 1; u <= e; ++u) p.day[at(p, u)] = 1;
        me = e;
        return;
    }
    if (ms >= 0) write_event(p, ms, me);
    ms = a;
    me = e;
    for (int u = a; u <= e; ++u) p.day[at(p, u)] = 1;
    p.st[at(p, a)] = 1;
}

__global__ void rle_kernel(const uint8_t* __restrict__ bthresh, Params p,
                           int* __restrict__ slot, int* __restrict__ nev) {
    p.c = blockIdx.x * kThreads + threadIdx.x;
    if (p.c >= p.C) return;
    const bool full = p.ev_id != nullptr;

    int rs = -1, ms = -1, me = -1;
    for (int t0 = 0; t0 < p.T; t0 += kChunk) {
        const int n = min(kChunk, p.T - t0);
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
            if (j < n && __ldg(bthresh + at(p, t0 + j))) m |= 1u << j;
        for (int j = 0; j < n; ++j) {
            const int t = t0 + j;
            const size_t o = at(p, t);
            p.day[o] = 0;
            p.st[o] = 0;
            if (full) {
                p.ev_id[o] = -1;
                p.ev_start[o] = -1;
                p.ev_end[o] = -1;
            }
            if ((m >> j) & 1u) {
                if (rs < 0) rs = t;
            } else if (rs >= 0) {
                close_run(p, rs, t - 1, ms, me);
                rs = -1;
            }
        }
    }
    if (rs >= 0) close_run(p, rs, p.T - 1, ms, me);
    if (ms >= 0) write_event(p, ms, me);

    // slot = cumsum(is_start) - 1 over every day; n_events
    int cnt = 0;
    for (int t0 = 0; t0 < p.T; t0 += kChunk) {
        const int n = min(kChunk, p.T - t0);
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
            if (j < n && p.st[at(p, t0 + j)]) m |= 1u << j;
        for (int j = 0; j < n; ++j) {
            cnt += (m >> j) & 1u;
            slot[at(p, t0 + j)] = cnt - 1;
        }
    }
    nev[p.c] = cnt;
}

}  // namespace

// bthresh, day, st: (T, C) uint8 0/1; slot: (T, C) int32; nev: (C,) int32.
// ev_id/ev_start/ev_end: (T, C) int32, or all three null.
extern "C" int xmhw_rle(const uint8_t* bthresh, int T, int C, int min_dur,
                        int join, int max_gap, int quirk, uint8_t* day,
                        uint8_t* st, int* slot, int* nev, int* ev_id,
                        int* ev_start, int* ev_end, void* stream) {
    Params p{T, C, 0, min_dur, join, max_gap, quirk, day, st,
             ev_id, ev_start, ev_end};
    const int blocks = (C + kThreads - 1) / kThreads;
    rle_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        bthresh, p, slot, nev);
    return (int)cudaGetLastError();
}
