// Per-event statistics of the 31-variable event table in one forward scan.
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
// What bounds it on the H100: device memory reads and, with one thread
// per cell, latency. Per (day, cell) it reads ts (4 bytes), event_day and
// is_start (1 byte each) from DRAM and thresh/seas through doy_pos from
// the (ndoy, C) climatology, which stays in L2: ~0.35 GB of DRAM reads per
// 14,610 x 4,096 block. Writes are (30 + 3) x K x C words, written once.
//
// Design: one thread per cell walks time forward; neighbouring threads
// take neighbouring cells, so each time row is one coalesced read. The
// carried values live in registers and reset at is_start. At an event's
// last day (day[t] && (t == T-1 || !day[t+1])) the thread writes the
// event's results straight into slot (channel, k, cell) of the
// (30, K, C) float and (3, K, C) int outputs, with k = (starts seen) - 1
// (the RLE kernel's slot, counted in a register instead of read back) and
// only if k < K. This takes the place of the TPU path's state array, its
// counting and its gather. Variances use Welford's update per event, so
// no per-cell shift constants (and no first pass) are needed. The start
// row is carried explicitly from is_start, never read back from the
// first-finite-relSeas channel. Rows are loaded in batches of 8 (plus one
// row of lookahead for day[t+1] and the next day's anomaly) so that ~50
// loads are in flight per thread. Slots from min(n_events, K) to K-1 are
// filled with NaN / -1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 8;  // rows per batched load
constexpr int kNF = 30;    // float channels, see ops/detect_scan.py
constexpr int kNI = 3;     // int channels: start, end, peak

struct Moments {
    int n;
    float s, mean, m2;
};

__device__ __forceinline__ void moments_reset(Moments& m) {
    m.n = 0;
    m.s = 0.0f;
    m.mean = 0.0f;
    m.m2 = 0.0f;
}

__device__ __forceinline__ void moments_add(Moments& m, float x) {
    if (!isfinite(x)) return;
    m.n += 1;
    m.s += x;
    const float d = x - m.mean;
    m.mean += d / (float)m.n;
    m.m2 += d * (x - m.mean);
}

// channels base .. base+3: count, sum, mean, standard deviation
__device__ __forceinline__ void moments_put(float* f, size_t stride,
                                            int base, const Moments& m) {
    const float nf = (float)m.n;
    f[base * stride] = nf;
    f[(base + 1) * stride] = m.n > 0 ? m.s : NAN;
    f[(base + 2) * stride] = m.n > 0 ? m.s / nf : NAN;
    f[(base + 3) * stride] =
        m.n > 1 ? sqrtf(fmaxf(m.m2 / (nf - 1.0f), 0.0f)) : NAN;
}

struct EventState {
    Moments rs, rt, sv, ma;
    int dmod, dstr, dsev, dext, nct;
    float mx_rs, mx_sv, mx_ct;
    float relt_pk, mabs_pk, rs_first, rs_last, ap_first, am_last;
    int start, pk;
    bool has_ap;
};

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

__device__ void state_put(const EventState& s, int end, float* f, int* io,
                          size_t stride) {
    const bool any = s.rs.n > 0;
    moments_put(f, stride, 0, s.rs);
    moments_put(f, stride, 4, s.rt);
    moments_put(f, stride, 8, s.sv);
    moments_put(f, stride, 12, s.ma);
    f[16 * stride] = (float)s.dmod;
    f[17 * stride] = (float)s.dstr;
    f[18 * stride] = (float)s.dsev;
    f[19 * stride] = (float)s.dext;
    f[20 * stride] = (float)s.nct;
    f[21 * stride] = any ? s.mx_rs : NAN;
    f[22 * stride] = s.sv.n > 0 ? s.mx_sv : NAN;
    f[23 * stride] = s.nct > 0 ? s.mx_ct : NAN;
    f[24 * stride] = any ? s.rs_first : NAN;
    f[25 * stride] = any ? s.rs_last : NAN;
    f[26 * stride] = s.has_ap ? s.ap_first : NAN;
    f[27 * stride] = s.am_last;
    f[28 * stride] = any ? s.relt_pk : NAN;
    f[29 * stride] = any ? s.mabs_pk : NAN;
    io[0] = s.start;
    io[stride] = end;
    io[2 * stride] = any ? s.pk : -1;
}

__global__ void event_scan_kernel(const float* __restrict__ ts,
                                  const float* __restrict__ th,
                                  const float* __restrict__ se,
                                  const int* __restrict__ doy_pos,
                                  const uint8_t* __restrict__ day,
                                  const uint8_t* __restrict__ st,
                                  int T, int C, int K,
                                  float* __restrict__ fout,
                                  int* __restrict__ iout) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= C) return;
    const size_t stride = (size_t)K * C;

    EventState s;
    state_reset(s, 0);
    int cnt = 0;             // is_start days seen = slot + 1
    float prev_anom = NAN;   // ts - seas of day t-1
    for (int t0 = 0; t0 < T; t0 += kChunk) {
        float x[kChunk + 1], h[kChunk + 1], e[kChunk + 1];
        uint32_t dbits = 0u, sbits = 0u;
#pragma unroll
        for (int j = 0; j <= kChunk; ++j) {
            const int t = t0 + j;
            if (t < T) {
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
        for (int j = 0; j < kChunk; ++j) {
            const int t = t0 + j;
            if (t < T) {
                const float anom = x[j] - e[j];
                if ((sbits >> j) & 1u) {
                    state_reset(s, t);
                    ++cnt;
                }
                if ((dbits >> j) & 1u) {
                    state_add(s, t, x[j], h[j], e[j], prev_anom,
                              x[j + 1] - e[j + 1]);
                    const bool last = !((dbits >> (j + 1)) & 1u);
                    if (last && cnt >= 1 && cnt - 1 < K) {
                        const size_t o = (size_t)(cnt - 1) * C + c;
                        state_put(s, t, fout + o, iout + o, stride);
                    }
                }
                prev_anom = anom;
            }
        }
    }
    for (int k = min(cnt, K); k < K; ++k) {
        const size_t o = (size_t)k * C + c;
        for (int ch = 0; ch < kNF; ++ch) fout[ch * stride + o] = NAN;
        for (int ch = 0; ch < kNI; ++ch) iout[ch * stride + o] = -1;
    }
}

}  // namespace

// ts: (T, C) float32; th/se: (ndoy, C) float32; doy_pos: (T,) int32 rows
// of th/se; day, st: (T, C) uint8 0/1 (event_day, is_start of the RLE).
// fout: (30, K, C) float32; iout: (3, K, C) int32.
extern "C" int xmhw_event_scan(const float* ts, const float* th,
                               const float* se, const int* doy_pos,
                               const uint8_t* day, const uint8_t* st,
                               int T, int C, int K, float* fout, int* iout,
                               void* stream) {
    const int blocks = (C + kThreads - 1) / kThreads;
    event_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ts, th, se, doy_pos, day, st, T, C, K, fout, iout);
    return (int)cudaGetLastError();
}
