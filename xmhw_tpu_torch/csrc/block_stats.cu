// Year-block statistics of a cell block in two passes: the event table's
// aggregations per year bin (block_average's event half, reference
// xmhw/stats.py:322-363) and the per-day ts and category statistics per
// year bin (its day half, stats.py:366-428).
//
// Replaces no TPU kernel: the JAX package leaves both reductions to XLA
// (xmhw_tpu/core/stats.py: binned_event_stats, binned_day_stats), which
// fuses them. In eager torch the same reductions (core/stats.py, the plain
// versions) ran as a loop over the bins, aggregations and rows: 7,624
// small launches and three (T, C) temporaries per 4,096-cell block of
// 14,610 days and 40 bins.
//
// What bounds it on the H100: bytes. A block reads the (T, C) series
// (239 MB), 13 (K, C) event variables and the slots' start days (29 MB)
// once, and the (ndoy, C) threshold and seasonal tables through doy_pos
// from L2 (12 MB); it writes 24 (nbins, C) rows: ~0.088 ms at 3.35 TB/s.
//
// Design: one thread per (bin, cell), the cells of a block's threads
// consecutive so that every (K, C) or (T, C) row read is coalesced, the
// bin on the grid's y axis; 40 bins x 4,096 cells is 163,840 threads. A
// thread adds its terms in index order (slots k = 0..K-1, days in time
// order) into a running float32 sum from 0.0: the order of the plain
// version's running sums (core/clim.py:ordered_sum, a cumsum), so both
// give the same bits at any block or shard width. A slot or day outside
// the thread's bin adds nothing, where the plain version adds 0.0; a sum
// that starts from +0.0 is never -0.0, so adding 0.0 changes no bit.
//  - events: a thread walks every slot of its cell (slots need not be
//    sorted by bin: block_average passes flattened tables), takes the
//    slot's bin from key[k, c] through a lookup table (the fused stage:
//    the start day's year bin, ybod[clamp(time_start)]) and, for its own
//    bin, keeps per variable the finite count and sum, and the
//    intensity_max maximum. The 13 variables are read in place (a struct
//    of pointers), the cold flip a sign bit each.
//  - days: a thread walks days edges[b] .. edges[b+1]-1, keeps the finite
//    count, sum, maximum and minimum of ts and the four category counts,
//    the category computed inline as floor(1 + (ts - th) / (th - se)) in
//    float32 in that order of operations (no --use_fast_math: IEEE
//    division, as torch's), th and se read at doy_pos[t].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // cells per block
constexpr int kNV = 13;        // core/stats.py EVENT_VARS
constexpr int kNAgg = 15;      // core/stats.py EVENT_AGGS
constexpr int kMaxVar = 2;     // intensity_max

struct EventVars {
    const float* v[kNV];
};

// torch's NaN (the quiet NaN of a Python float)
__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__global__ void __launch_bounds__(kThreads)
block_event_kernel(EventVars src, unsigned neg, const int* __restrict__ key,
                   const int* __restrict__ lut, int nlut, int K, int C,
                   int nbins, float* __restrict__ out) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (c >= C) return;
    int n[kNV];
    float s[kNV];
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
        n[i] = 0;
        s[i] = 0.0f;
    }
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) {
        const size_t o = (size_t)k * C + c;
        const int kk = key[o];
        if (kk < 0) continue;
        const int bin = lut != nullptr ? __ldg(lut + min(kk, nlut - 1)) : kk;
        if (bin < 0 || min(bin, nbins - 1) != b) continue;
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
            float x = src.v[i][o];
            if ((neg >> i) & 1u) x = -x;
            if (!isfinite(x)) continue;
            n[i] += 1;
            s[i] += x;
            if (i == kMaxVar && x > mx) mx = x;
        }
    }
    // the rows of EVENT_AGGS, in its order
    const size_t st = (size_t)nbins * C;
    float* o = out + (size_t)b * C + c;
    auto mean = [&](int i) { return n[i] > 0 ? s[i] / (float)n[i] : qnan(); };
    o[0] = (float)n[0];                          // ecount
    o[st] = mean(1);                             // duration
    o[2 * st] = mean(kMaxVar);                   // intensity_max
    o[3 * st] = n[kMaxVar] > 0 ? mx : qnan();    // intensity_max_max
    o[4 * st] = mean(3);                         // intensity_mean
    o[5 * st] = mean(4);                         // intensity_cumulative
    o[6 * st] = s[4];  // total_icum: 0.0 for an empty bin, as pandas
#pragma unroll
    for (int i = 5; i < kNV; ++i) o[(i + 2) * st] = mean(i);
}

__global__ void __launch_bounds__(kThreads)
block_day_kernel(const float* __restrict__ ts, const float* __restrict__ th,
                 const float* __restrict__ se,
                 const int* __restrict__ doy_pos,
                 const int* __restrict__ edges, int C, int nbins,
                 int count_nans, float* __restrict__ out) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (c >= C) return;
    const int t0 = edges[b], t1 = edges[b + 1];
    const bool cats = th != nullptr;
    int n = 0, n1 = 0, n2 = 0, n3 = 0, n4 = 0;
    float s = 0.0f, mx = -INFINITY, mn = INFINITY;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
        const float x = ts[(size_t)t * C + c];
        if (isfinite(x)) {
            n += 1;
            s += x;
            mx = x > mx ? x : mx;
            mn = x < mn ? x : mn;
        }
        if (cats) {
            const size_t p = (size_t)__ldg(doy_pos + t) * C + c;
            const float h = th[p], e = se[p];
            const float q = floorf(1.0f + (x - h) / (h - e));
            n1 += q == 1.0f;
            n2 += q == 2.0f;
            n3 += q == 3.0f;
            n4 += q == 4.0f;
        }
    }
    const float cnt = (float)n;
    const size_t stride = (size_t)nbins * C;
    float* o = out + (size_t)b * C + c;
    o[0] = n > 0 ? s / cnt : qnan();
    o[stride] = n > 0 ? mx : qnan();
    o[2 * stride] = n > 0 ? mn : qnan();
    int row = 3;
    if (cats) {
        o[3 * stride] = (float)n1;
        o[4 * stride] = (float)n2;
        o[5 * stride] = (float)n3;
        o[6 * stride] = (float)n4;
        o[7 * stride] = (float)(n1 + n2 + n3 + n4);
        row = 8;
    }
    if (count_nans) o[row * stride] = (float)(t1 - t0) - cnt;
}

}  // namespace

// vals: kNV device pointers (host array) to (K, C) float32, EVENT_VARS
// order; neg: bit i negates variable i. key: (K, C) int32; slot (k, c) is
// in bin lut[min(key, nlut - 1)] (lut: (nlut,) int32) or, without lut,
// bin key; in none where key < 0 or the bin < 0; bins past nbins - 1
// count in the last. out: (kNAgg, nbins, C) float32.
extern "C" int xmhw_block_event_stats(const void* const* vals, int neg,
                                      const int* key, const int* lut,
                                      int nlut, int K, int C, int nbins,
                                      float* out, void* stream) {
    if (C <= 0 || nbins <= 0) return 0;
    EventVars src;
    for (int i = 0; i < kNV; ++i) src.v[i] = (const float*)vals[i];
    const dim3 grid((C + kThreads - 1) / kThreads, nbins);
    block_event_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, (unsigned)neg, key, lut, nlut, K, C, nbins, out);
    return (int)cudaGetLastError();
}

// ts: (T, C) float32; th/se: (ndoy, C) float32, or both null for no
// category rows; doy_pos: (T,) int32 rows of th/se; edges: (nbins + 1,)
// int32 day indexes. out: (3 [+ 5 with th] [+ 1 with count_nans], nbins,
// C) float32: ts_mean, ts_max, ts_min, [moderate, strong, severe, extreme,
// total days], [nan_days].
extern "C" int xmhw_block_day_stats(const float* ts, const float* th,
                                    const float* se, const int* doy_pos,
                                    const int* edges, int C, int nbins,
                                    int count_nans, float* out,
                                    void* stream) {
    if (C <= 0 || nbins <= 0) return 0;
    const dim3 grid((C + kThreads - 1) / kThreads, nbins);
    block_day_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        ts, th, se, doy_pos, edges, C, nbins, count_nans, out);
    return (int)cudaGetLastError();
}
