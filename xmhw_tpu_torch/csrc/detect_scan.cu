// Per-event statistics of the 31-variable event table in one forward scan,
// split over time.
//
// Replaces the TPU kernel fused_detect_scans (xmhw_tpu/ops/pallas/
// detect_scan.py, body _kernel) together with the end counting and the
// boundary gather that its caller runs on the kernel's (T/8, 32, C) state
// array (core/features_scan.py:324-575). It computes, per event: finite
// counts, sums, means and standard deviations of relSeas, relThresh,
// severity and the absolute value; the category-day counts; the relSeas
// maximum with its first argmax and relThresh/absolute value there; the
// severity and category maxima; the first and last finite relSeas; the
// first finite anomaly of the day before and the last finite anomaly of
// the day after an event day; and the event's start and end rows.
//
// What bounds it on the H100: each day depends on the one before through
// ~35 registers of event state, and an event day costs a few hundred
// instructions; a warp of 32 cells has an event lane on ~90 % of days.
// DRAM traffic is small: ~0.43 GB per 14,610 x 4,096 block (ts 4 bytes,
// event_day and is_start 1 byte each per (day, cell), thresh/seas through
// doy_pos from the (ndoy, C) climatology in L2, (30 + 3) x K x C output
// words), ~0.13 ms at 3.35 TB/s. One thread per cell walking all of time
// gives a 4,096-cell block 128 warps, one per SM: latency bound.
//
// Design: a block owns 32 cells, one per lane, and kWarps warps; warp w
// owns days [w L, (w+1) L), L = ceil(T / kWarps), so a 4,096-cell block
// runs 16 warps per SM. Neighbouring lanes read neighbouring cells, so
// every row is one coalesced read. Per block:
//  1. each warp counts is_start in its segment; an exclusive prefix of the
//     counts over the warps (shared memory) gives the segment's first slot;
//  2. each warp walks its segment forward with the event state in
//     registers, reading the anomaly of the day before the segment first
//     and the row after it as lookahead, so "last day" (!day[t+1]) and the
//     next-day anomaly are right across the edge. An event that starts and
//     ends in the segment goes, if its slot k < K, as one 36-word record
//     (9 float4 stores) to the block's (K, 32 cells) records in scratch
//     memory. The segment's two partial events go to shared memory: the
//     head (an event open on its first day, up to its close or the
//     segment's end) and the tail (an event still open on its last day);
//  3. warp 0 walks the segments in order, merges each tail with the
//     following heads until the event closes and writes its record (if
//     k < K). Every channel merges associatively: counts and sums add,
//     shifted sums are rebased onto the left shift, the relSeas maximum
//     keeps the left argmax unless the right one is strictly greater,
//     first-finite values come from the left if it has one, last-finite
//     values from the right if it has one, the start from the left, the
//     end is the day the head closed;
//  4. the block copies its records to the (30, K, C) float and (3, K, C)
//     int outputs, one coalesced row of 32 cells per store, and fills slots
//     min(n_events, K) .. K-1 with NaN / -1. (Storing 33 scattered words
//     per event straight into those outputs cost ~0.3 ms more.)
// Moments are sums shifted by the event's first finite value, n,
// sum(x - k) and sum((x - k)^2): no division per day (Welford's update
// cost ~13 % more) and no per-cell shift constants. The start row is
// carried explicitly from is_start, never read back from the
// first-finite-relSeas channel. Each chunk of 8 rows (plus one row of
// lookahead) is loaded at once into lane-private shared memory and walked
// by a loop that is not unrolled: unrolled over the chunk, the walk was
// ~6,900 SASS instructions and 2.3x slower. The head and tail states of
// 32 cells x 16 warps (143 KB) and the staged rows (55 KB) fill one SM's
// shared memory, so one block runs per SM (128 blocks for 132 SMs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // cells per block, one per lane
constexpr int kWarps = 16;  // time segments per block, one per warp
constexpr int kThreads = kLanes * kWarps;
constexpr int kChunk = 8;   // rows per batched load
constexpr int kNF = 30;     // float channels, see ops/detect_scan.py
constexpr int kNI = 3;      // int channels: start, end, peak
constexpr int kRec = 9;     // float4 per event record (kNF + kNI words)
static_assert(4 * kRec >= kNF + kNI, "event record too small");

struct Moments {
    int n;
    float k, p, q;  // shift (first finite value), sum(x - k), sum((x - k)^2)
};

__device__ __forceinline__ void moments_reset(Moments& m) {
    m.n = 0;
    m.k = 0.0f;
    m.p = 0.0f;
    m.q = 0.0f;
}

__device__ __forceinline__ void moments_add(Moments& m, float x) {
    if (!isfinite(x)) return;
    if (m.n == 0) m.k = x;
    m.n += 1;
    const float y = x - m.k;
    m.p += y;
    m.q = fmaf(y, y, m.q);
}

// l = l followed by r: r's sums rebased onto l's shift
__device__ __forceinline__ void moments_merge(Moments& l, const Moments& r) {
    if (r.n == 0) return;
    if (l.n == 0) {
        l = r;
        return;
    }
    const float d = r.k - l.k;
    const float nr = (float)r.n;
    l.q += r.q + d * (2.0f * r.p + nr * d);
    l.p += r.p + nr * d;
    l.n += r.n;
}

// v[0..3]: count, sum, mean, standard deviation
__device__ __forceinline__ void moments_vals(float* v, const Moments& m) {
    const float nf = (float)m.n;
    const float s = fmaf(nf, m.k, m.p);
    v[0] = nf;
    v[1] = m.n > 0 ? s : NAN;
    v[2] = m.n > 0 ? s / nf : NAN;
    v[3] = m.n > 1 ? sqrtf(fmaxf((m.q - m.p * m.p / nf) / (nf - 1.0f), 0.0f))
                   : NAN;
}

struct EventState {
    Moments rs, rt, sv, ma;
    int dmod, dstr, dsev, dext, nct;
    float mx_rs, mx_sv, mx_ct;
    float relt_pk, mabs_pk, rs_first, rs_last, ap_first, am_last;
    int start, pk;
    bool has_ap;
};

// a segment's share of one event, kept in shared memory until the merge
struct Partial {
    EventState s;
    int end;   // head: the day it closed
    int flag;  // head: still open at the segment's end; tail: present
};

constexpr size_t kSmem = 2 * kThreads * sizeof(Partial) +
                         kThreads * sizeof(int) +
                         3 * (kChunk + 1) * kThreads * sizeof(float);

__device__ __forceinline__ void state_reset(EventState& s, int t) {
    moments_reset(s.rs);
    moments_reset(s.rt);
    moments_reset(s.sv);
    moments_reset(s.ma);
    s.dmod = s.dstr = s.dsev = s.dext = s.nct = 0;
    s.mx_rs = s.mx_sv = s.mx_ct = -INFINITY;
    s.relt_pk = s.mabs_pk = s.rs_first = s.rs_last = NAN;
    s.ap_first = s.am_last = NAN;
    s.start = t;
    s.pk = t;
    s.has_ap = false;
}

// one event day: x = ts, h = thresh, e = seas at t; prev/next = the
// anomaly ts - seas of days t-1 and t+1 (NaN outside the series)
__device__ __forceinline__ void state_add(EventState& s, int t, float x,
                                          float h, float e, float prev,
                                          float next) {
    const float rs = x - e;
    const float rt = x - h;
    const float thse = h - e;
    const float sv = rs / -thse;
    const float ct = floorf(1.0f + rt / thse);
    if (isfinite(rs)) {
        if (s.rs.n == 0) s.rs_first = rs;
        s.rs_last = rs;
        if (rs > s.mx_rs) {
            s.mx_rs = rs;
            s.pk = t;
            s.relt_pk = rt;
            s.mabs_pk = x;
        }
    }
    moments_add(s.rs, rs);
    moments_add(s.rt, rt);
    moments_add(s.sv, sv);
    moments_add(s.ma, x);
    if (isfinite(sv)) s.mx_sv = fmaxf(s.mx_sv, sv);
    if (isfinite(ct)) {
        s.nct += 1;
        s.mx_ct = fmaxf(s.mx_ct, ct);
    }
    s.dmod += ct == 1.0f;
    s.dstr += ct == 2.0f;
    s.dsev += ct == 3.0f;
    s.dext += ct >= 4.0f;
    if (!s.has_ap && isfinite(prev)) {
        s.has_ap = true;
        s.ap_first = prev;
    }
    if (isfinite(next)) s.am_last = next;
}

// l = the event's days in l followed by those in r (r's days come later)
__device__ void state_merge(EventState& l, const EventState& r) {
    if (l.rs.n == 0) l.rs_first = r.rs_first;
    if (r.rs.n > 0) l.rs_last = r.rs_last;
    if (r.mx_rs > l.mx_rs) {
        l.mx_rs = r.mx_rs;
        l.pk = r.pk;
        l.relt_pk = r.relt_pk;
        l.mabs_pk = r.mabs_pk;
    }
    moments_merge(l.rs, r.rs);
    moments_merge(l.rt, r.rt);
    moments_merge(l.sv, r.sv);
    moments_merge(l.ma, r.ma);
    l.dmod += r.dmod;
    l.dstr += r.dstr;
    l.dsev += r.dsev;
    l.dext += r.dext;
    l.nct += r.nct;
    l.mx_sv = fmaxf(l.mx_sv, r.mx_sv);
    l.mx_ct = fmaxf(l.mx_ct, r.mx_ct);
    if (!l.has_ap) {
        l.has_ap = r.has_ap;
        l.ap_first = r.ap_first;
    }
    if (isfinite(r.am_last)) l.am_last = r.am_last;
}

// The event's record: channels 0..29 of F, then start, end and peak as
// int bits, then padding; kRec float4 in all.
__device__ void state_pack(const EventState& s, int end, float4* rec) {
    const bool any = s.rs.n > 0;
    float v[4 * kRec];
    moments_vals(v, s.rs);
    moments_vals(v + 4, s.rt);
    moments_vals(v + 8, s.sv);
    moments_vals(v + 12, s.ma);
    v[16] = (float)s.dmod;
    v[17] = (float)s.dstr;
    v[18] = (float)s.dsev;
    v[19] = (float)s.dext;
    v[20] = (float)s.nct;
    v[21] = any ? s.mx_rs : NAN;
    v[22] = s.sv.n > 0 ? s.mx_sv : NAN;
    v[23] = s.nct > 0 ? s.mx_ct : NAN;
    v[24] = any ? s.rs_first : NAN;
    v[25] = any ? s.rs_last : NAN;
    v[26] = s.has_ap ? s.ap_first : NAN;
    v[27] = s.am_last;
    v[28] = any ? s.relt_pk : NAN;
    v[29] = any ? s.mabs_pk : NAN;
    v[30] = __int_as_float(s.start);
    v[31] = __int_as_float(end);
    v[32] = __int_as_float(any ? s.pk : -1);
    v[33] = v[34] = v[35] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRec; ++i)
        rec[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                             v[4 * i + 3]);
}

__global__ void __launch_bounds__(kThreads, 1)
event_scan_kernel(const float* __restrict__ ts, const float* __restrict__ th,
                  const float* __restrict__ se,
                  const int* __restrict__ doy_pos,
                  const uint8_t* __restrict__ day,
                  const uint8_t* __restrict__ st, int T, int C, int K,
                  float4* __restrict__ recs, float* __restrict__ fout,
                  int* __restrict__ iout) {
    extern __shared__ __align__(16) unsigned char smem[];
    Partial* heads = reinterpret_cast<Partial*>(smem);
    Partial* tails = heads + kThreads;
    int* counts = reinterpret_cast<int*>(tails + kThreads);
    float* stage = reinterpret_cast<float*>(counts + kThreads);

    const int lane = threadIdx.x % kLanes;
    const int w = threadIdx.x / kLanes;
    const int me = threadIdx.x;  // = w * kLanes + lane
    const int c = blockIdx.x * kLanes + lane;
    const bool live = c < C;
    const int L = (T + kWarps - 1) / kWarps;
    const int a = min(w * L, T);
    const int b = min(a + L, T);
    const size_t stride = (size_t)K * C;
    recs += (size_t)blockIdx.x * K * kLanes * kRec;  // this block's records

    // 1. starts in [a, b); the segment's first slot is the count before it
    int n = 0;
    if (live) {
#pragma unroll 8
        for (int t = a; t < b; ++t) n += __ldg(st + (size_t)t * C + c);
    }
    counts[me] = n;
    __syncthreads();
    int base = 0, total = 0;
    for (int v = 0; v < kWarps; ++v) {
        const int k = counts[v * kLanes + lane];
        base += v < w ? k : 0;
        total += k;
    }

    // 2. walk [a, b); rows up to b are read (b is the lookahead row)
    EventState s;
    state_reset(s, a);
    heads[me].s = s;
    heads[me].end = a - 1;
    heads[me].flag = 0;
    tails[me].flag = 0;
    int cnt = 0;             // is_start days seen in the segment
    bool open = false;       // day[t] && day[t+1] at the last day walked
    float prev_anom = NAN;   // ts - seas of day t-1
    if (live && a > 0) {
        const size_t q = (size_t)__ldg(doy_pos + a - 1) * C + c;
        prev_anom = __ldg(ts + (size_t)(a - 1) * C + c) - __ldg(se + q);
    }
    const int rows = min(b + 1, T);
    float* sx = stage + me;  // this thread's rows [j][x, h, e], kThreads apart
    for (int t0 = a; live && t0 < b; t0 += kChunk) {
        uint32_t dbits = 0u, sbits = 0u;
        {
            float x[kChunk + 1], h[kChunk + 1], e[kChunk + 1];
#pragma unroll
            for (int j = 0; j <= kChunk; ++j) {
                const int t = t0 + j;
                if (t < rows) {
                    const size_t o = (size_t)t * C + c;
                    const size_t q = (size_t)__ldg(doy_pos + t) * C + c;
                    x[j] = __ldg(ts + o);
                    h[j] = __ldg(th + q);
                    e[j] = __ldg(se + q);
                    if (__ldg(day + o)) dbits |= 1u << j;
                    if (__ldg(st + o)) sbits |= 1u << j;
                } else {
                    x[j] = h[j] = e[j] = NAN;
                }
            }
#pragma unroll
            for (int j = 0; j <= kChunk; ++j) {
                sx[(3 * j) * kThreads] = x[j];
                sx[(3 * j + 1) * kThreads] = h[j];
                sx[(3 * j + 2) * kThreads] = e[j];
            }
        }
        const int jn = min(kChunk, b - t0);
#pragma unroll 1
        for (int j = 0; j < jn; ++j) {
            const int t = t0 + j;
            const float x = sx[(3 * j) * kThreads];
            const float e = sx[(3 * j + 2) * kThreads];
            const float anom = x - e;
            if ((sbits >> j) & 1u) {
                state_reset(s, t);
                ++cnt;
            }
            const bool today = (dbits >> j) & 1u;
            const bool next = (dbits >> (j + 1)) & 1u;
            if (today) {
                state_add(s, t, x, sx[(3 * j + 1) * kThreads], e, prev_anom,
                          sx[(3 * j + 3) * kThreads] -
                              sx[(3 * j + 5) * kThreads]);
                if (!next) {
                    if (cnt == 0) {  // the head closes
                        heads[me].s = s;
                        heads[me].end = t;
                    } else if (base + cnt - 1 < K) {
                        state_pack(s, t, recs + ((size_t)(base + cnt - 1) *
                                                 kLanes + lane) * kRec);
                    }
                }
            }
            open = today && next;
            prev_anom = anom;
        }
    }
    if (open) {
        if (cnt == 0) {  // one event runs through the whole segment
            heads[me].s = s;
            heads[me].flag = 1;
        } else {
            tails[me].s = s;
            tails[me].flag = 1;
        }
    }
    __syncthreads();

    // 3. warp 0 joins each tail to the heads that follow it
    if (w == 0 && live) {
        EventState acc;
        bool carry = false;
        int slot = 0, first = 0;
        for (int v = 0; v < kWarps; ++v) {
            const Partial& hd = heads[v * kLanes + lane];
            if (carry) {
                state_merge(acc, hd.s);
                if (!hd.flag) {
                    state_pack(acc, hd.end,
                               recs + ((size_t)slot * kLanes + lane) * kRec);
                    carry = false;
                }
            }
            first += counts[v * kLanes + lane];
            if (tails[v * kLanes + lane].flag && first - 1 < K) {
                acc = tails[v * kLanes + lane].s;
                slot = first - 1;
                carry = true;
            }
        }
    }

    __syncthreads();

    // 4. records to (channel, k, cell), a coalesced row per warp and
    // channel; slots from min(n_events, K) on get NaN / -1
    if (live) {
        const int used = min(total, K);
        for (int k = w; k < K; k += kWarps) {
            const size_t o = (size_t)k * C + c;
            if (k < used) {
                const float4* r = recs + ((size_t)k * kLanes + lane) * kRec;
                float v[4 * kRec];
#pragma unroll
                for (int i = 0; i < kRec; ++i) {
                    const float4 q = r[i];
                    v[4 * i] = q.x;
                    v[4 * i + 1] = q.y;
                    v[4 * i + 2] = q.z;
                    v[4 * i + 3] = q.w;
                }
#pragma unroll
                for (int ch = 0; ch < kNF; ++ch)
                    fout[ch * stride + o] = v[ch];
#pragma unroll
                for (int ch = 0; ch < kNI; ++ch)
                    iout[ch * stride + o] = __float_as_int(v[kNF + ch]);
            } else {
                for (int ch = 0; ch < kNF; ++ch) fout[ch * stride + o] = NAN;
                for (int ch = 0; ch < kNI; ++ch) iout[ch * stride + o] = -1;
            }
        }
    }
}

}  // namespace

// Floats of scratch that xmhw_event_scan needs for C cells and K slots.
extern "C" long long xmhw_event_scan_scratch(int C, int K) {
    return (long long)((C + kLanes - 1) / kLanes) * K * kLanes * 4 * kRec;
}

// ts: (T, C) float32; th/se: (ndoy, C) float32; doy_pos: (T,) int32 rows
// of th/se; day, st: (T, C) uint8 0/1 (event_day, is_start of the RLE);
// recs: xmhw_event_scan_scratch(C, K) floats, 16-byte aligned.
// fout: (30, K, C) float32; iout: (3, K, C) int32.
extern "C" int xmhw_event_scan(const float* ts, const float* th,
                               const float* se, const int* doy_pos,
                               const uint8_t* day, const uint8_t* st,
                               int T, int C, int K, float* recs, float* fout,
                               int* iout, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        event_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (C + kLanes - 1) / kLanes;
    event_scan_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
        ts, th, se, doy_pos, day, st, T, C, K,
        reinterpret_cast<float4*>(recs), fout, iout);
    return (int)cudaGetLastError();
}

// The launch shape: time segments (warps) per block, threads per block and
// dynamic shared memory bytes per block.
extern "C" void xmhw_event_scan_config(int* warps, int* threads,
                                       int* smem_bytes) {
    *warps = kWarps;
    *threads = kThreads;
    *smem_bytes = (int)kSmem;
}
