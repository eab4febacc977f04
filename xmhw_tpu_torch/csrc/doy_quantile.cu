// Pooled day-of-year percentile threshold and mean climatology.
//
// Replaces the TPU kernel pallas_doy_clim (xmhw_tpu/ops/pallas/
// doy_quantile.py:299, kernel body _kernel_batched). For every (doy, cell)
// it pools the +-w-day window of every year through the range tables
// starts/lens (core/calendar.build_window_ranges: one contiguous run of at
// most rmax rows per (doy, year)), drops NaN values, and returns the
// linear-interpolation percentile and the mean; NaN where the pool is
// empty.
//
// What bounds it on the H100: not device memory. The series is read from
// DRAM about once (neighbouring doys share 10 of 11 window rows, and the
// rows of the few doys in flight stay in the 50 MB L2): 252 MB, 0.075 ms
// at 40 years and 4,096 cells. Each block rereads its doy's pool from L2
// (2.6 GB in all), and a radix select makes one counting pass over the
// pool per key bit it needs (~23 of 32 for SST pools after the skip):
// L2 latency while staging, then issue slots and the latency of the
// warp reductions between dependent passes.
//
// Design: a block is one doy and 32 neighbouring cells, 8 warps.
// 1. Stage. Lane l of a warp finds where pool row j0 + l lies in the
//    series; the warp then loads those 32 rows, each a coalesced 128-byte
//    row of the block's cells, all in flight at once, and stores them as
//    keys (a missing value: 0xFFFFFFFF, above every finite key) in a
//    shared tile [Z][32], Z = ny*rmax, row z's cell c in column
//    c ^ (z & 31): the row stores and the column reads below are both
//    free of bank conflicts. The tile is ny*rmax*128 bytes: 42 KB at a
//    30-year climatology, 56 KB at 40 years, 227 KB (the most a block may
//    have) at Z = 1,816, the largest pool staged (longer ones: below).
// 2. One warp per pool. Lane l holds keys z = l + 32 i in registers
//    (KPT = ceil(Z / 32) per lane; template instances cover every Z up to
//    1,816). One pass gives the count, smallest and largest valid key
//    (__reduce_*_sync) and the float64 sum (__shfl_xor_sync).
// 3. The TPU kernel's common-prefix skip, per pool: every valid key shares
//    its bits above the highest bit of min ^ max, and so does the order
//    statistic, so lo starts as that prefix and the radix loop at that
//    bit. The result is bit-identical to the 32-step loop. SST pools share
//    8-12 leading bits.
// 4. Each radix step: every lane counts its keys below the candidate and
//    one __reduce_add_sync gives the pool's count; no shared memory. When
//    the pool's keys share the sign bit, key - cand fits in 31 bits and
//    its sign bit is the compare: two instructions a key.
// The steps' rule (the largest lo with #(key < lo) <= k), the cnt_le/hik
// rule for the (k+1)-th order statistic, the exact integer rank for an
// integral pctile and the interpolation rounded once in float64 with _rn
// intrinsics (nvcc contracts nothing) are core/clim._select_quantile's,
// so thresholds equal the plain version's bit for bit; the unsigned key
// order equals the JAX package's signed-key order. The mean is a float64
// sum rounded once, summed in another order than the plain version:
// within one float32 ulp of it.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): 64 registers per thread and no
// spill at 11 and 14 keys a lane (30- and 40-year pools), so 4 blocks,
// 32 warps, fit on an SM there; tools/torch_doy_variants.py prints the
// figures of every instance and the split of the time.
//
// Pools past the tile (Z > 1,816 rows: ERSST v5's 171 monthly years at
// w = 5, or daily records at w >= 11 over 80 years) take a second kernel,
// doy_quantile_long_kernel, with the same block (one doy, 32 cells, 8
// warps), the same common-prefix skip and the same radix select, but
// nothing staged: lane l of every warp owns cell c0 + l and warp w the
// pool's years w, w + 8, ...; each pass reads those rows from the series
// again (each a coalesced 128-byte row of the block's cells) and the 8
// warps' counts meet in shared memory. Blocks run column by column (all
// doys of 32 cells, then the next 32), so the blocks in flight reread
// the rows of a few columns (T x 128 B each: 4 MB at 85 daily years),
// which stay in the 50 MB L2, and a pass costs L2 reads, not DRAM. No
// scratch, no limit on Z; two passes more than the tile kernel's radix
// steps, each over the whole pool.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCells = 32;     // cells per block: one 128-byte row
constexpr int kWarps = 8;      // warps per block
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // key of a missing value
// the most rows a pool may have to be staged in the shared tile: 32
// cells of 4-byte keys a row in the 232,448 B a block may have
constexpr int kTileRows = 232448 / (kCells * 4);

__device__ __forceinline__ uint32_t float_key(float x) {
    const uint32_t b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

template <int KPT>
__global__ void __launch_bounds__(kWarps * 32)
doy_quantile_kernel(const float* __restrict__ ts,
                    const int* __restrict__ starts,
                    const int* __restrict__ lens, float* __restrict__ th,
                    float* __restrict__ se, int C, int ny, int rmax,
                    int pct_int, float q) {
    extern __shared__ uint32_t tile[];  // [Z][kCells], swizzled columns
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c0 = blockIdx.x * kCells;
    const int d = blockIdx.y;
    const int Z = ny * rmax;
    const bool live = c0 + lane < C;
    const int* st = starts + (size_t)d * ny;
    const int* ln = lens + (size_t)d * ny;

    // 1. stage the pool. Row j of the pool is day j % rmax of year
    // j / rmax's window, or nothing past the window's length. Lane l of a
    // warp finds where row j0 + l lies in the series, then the warp loads
    // the 32 rows, each a coalesced 128-byte row of the block's cells,
    // all 32 loads in flight.
    for (int j0 = warp * 32; j0 < Z; j0 += kWarps * 32) {
        int src = -1;
        if (j0 + lane < Z) {
            const int y = (j0 + lane) / rmax;
            const int r = j0 + lane - y * rmax;
            if (r < __ldg(ln + y)) src = __ldg(st + y) + r;
        }
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int row = __shfl_sync(kAll, src, i);
            v[i] = (row >= 0 && live)
                       ? __ldg(ts + (size_t)row * C + c0 + lane)
                       : NAN;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i)
            if (j0 + i < Z)
                tile[(j0 + i) * kCells + (lane ^ i)] =
                    isfinite(v[i]) ? float_key(v[i]) : kNone;
    }
    __syncthreads();

    for (int p = warp; p < kCells && c0 + p < C; p += kWarps) {
        uint32_t key[KPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const int z = lane + 32 * i;
            key[i] = z < Z ? tile[z * kCells + (p ^ lane)] : kNone;
        }

        // 2. count, smallest and largest key, float64 sum of the pool
        int n = 0;
        uint32_t kmin = kNone, kmax = 0u;
        double sum = 0.0;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const bool ok = key[i] != kNone;
            n += ok;
            kmin = min(kmin, key[i]);
            kmax = max(kmax, ok ? key[i] : 0u);
            if (ok) sum += (double)key_float(key[i]);
        }
        n = __reduce_add_sync(kAll, n);
        kmin = __reduce_min_sync(kAll, kmin);
        kmax = __reduce_max_sync(kAll, kmax);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kAll, sum, o);
        const size_t out = (size_t)d * C + c0 + p;
        if (n == 0) {
            if (lane == 0) th[out] = se[out] = NAN;
            continue;
        }

        // rank k and fraction of position q*(n-1)
        int k;
        float frac;
        if (pct_int >= 0) {
            const int num = (n - 1) * pct_int;
            k = num / 100;
            frac = __fmul_rn((float)(num - k * 100), 0.01f);
        } else {
            const float pos = __fmul_rn(q, __fsub_rn((float)n, 1.0f));
            k = max((int)floorf(pos), 0);
            frac = __fsub_rn(pos, (float)k);
        }

        // 3. common-prefix skip: lo starts as the bits above the highest
        // bit where the pool's keys differ (all of kmin when none differ)
        const uint32_t diff = kmin ^ kmax;
        int b = diff ? 31 - __clz((int)diff) : -1;
        uint32_t lo = b < 0 ? kmin : kmin & ~((2u << b) - 1u);

        // 4. MSB-first radix select: the largest lo with #(key < lo) <= k
        if (b < 31) {
            // Every valid key and candidate share the bits above b, so
            // key - cand fits in 31 bits and its sign bit is key < cand:
            // two instructions a key. Missing keys become kmax: never
            // below a candidate at or under kmax, and a candidate above
            // kmax has all n valid keys below it (n > k) and is refused
            // whatever they add. The pass after the loop gives the same
            // le and hik with them as with the missing-key marker.
#pragma unroll
            for (int i = 0; i < KPT; ++i)
                if (key[i] == kNone) key[i] = kmax;
            for (; b >= 0; --b) {
                const uint32_t cand = lo | (1u << b);
                uint32_t ca = 0u, cb = 0u;
#pragma unroll
                for (int i = 0; i < KPT; i += 2) {
                    ca += (key[i] - cand) >> 31;
                    if (i + 1 < KPT) cb += (key[i + 1] - cand) >> 31;
                }
                if ((int)__reduce_add_sync(kAll, ca + cb) <= k) lo = cand;
            }
        } else {  // the pool holds both signs: compare keys as they are
            for (; b >= 0; --b) {
                const uint32_t cand = lo | (1u << b);
                int ca = 0, cb = 0;
#pragma unroll
                for (int i = 0; i < KPT; i += 2) {
                    ca += key[i] < cand;
                    if (i + 1 < KPT) cb += key[i + 1] < cand;
                }
                if (__reduce_add_sync(kAll, ca + cb) <= k) lo = cand;
            }
        }
        // (k+1)-th order statistic: vk again when ties span position k+1,
        // else the smallest key strictly greater than lo
        int le = 0;
        uint32_t hik = kNone;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            le += key[i] <= lo;
            if (key[i] > lo) hik = min(hik, key[i]);
        }
        le = __reduce_add_sync(kAll, le);
        hik = __reduce_min_sync(kAll, hik);
        if (lane == 0) {
            const float vk = key_float(lo);
            const float vk1 = (le > k + 1) ? vk
                              : (hik != kNone ? key_float(hik) : vk);
            // vk + frac*(vk1 - vk) in float64 (the product is exact) and
            // rounded to float32: the plain version's arithmetic
            th[out] = __double2float_rn(__dadd_rn(
                (double)vk,
                __dmul_rn((double)frac, (double)__fsub_rn(vk1, vk))));
            se[out] = __double2float_rn(__ddiv_rn(sum, (double)n));
        }
    }
}

// Pools past the tile: lane l owns cell c0 + l, warp w the pool's years
// w, w + kWarps, ...; every pass walks the warp's rows in the series and
// calls f on each value of the lane's cell (NaN for a lane past C).
template <class F>
__device__ __forceinline__ void walk_pool(const float* __restrict__ col,
                                          const int* __restrict__ st,
                                          const int* __restrict__ ln,
                                          int C, int ny, int warp,
                                          bool live, F f) {
    for (int y = warp; y < ny; y += kWarps) {
        const float* p = col + (size_t)__ldg(st + y) * C;
        const int len = __ldg(ln + y);
#pragma unroll 8
        for (int r = 0; r < len; ++r)
            f(live ? __ldg(p + (size_t)r * C) : NAN);
    }
}

__device__ __forceinline__ uint32_t key_of(float v) {
    return isfinite(v) ? float_key(v) : kNone;
}

__global__ void __launch_bounds__(kWarps * 32)
doy_quantile_long_kernel(const float* __restrict__ ts,
                         const int* __restrict__ starts,
                         const int* __restrict__ lens, float* __restrict__ th,
                         float* __restrict__ se, int C, int ndoy, int ny,
                         int pct_int, float q) {
    __shared__ double s_sum[kWarps][32];
    __shared__ uint32_t s_lo[kWarps][32], s_hi[kWarps][32];
    __shared__ uint32_t s_hik[kWarps][32];
    __shared__ int s_cnt[2][kWarps][32];
    // the doys of one 32-cell column run next to each other: the blocks
    // in flight reread the series rows of a few columns, which stay in
    // L2, not the rows of a few doys across every column, which do not
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int d = blockIdx.x % ndoy;
    const int c = blockIdx.x / ndoy * kCells + lane;
    const bool live = c < C;
    const float* col = ts + (live ? c : 0);
    const int* st = starts + (size_t)d * ny;
    const int* ln = lens + (size_t)d * ny;

    // 1. count, smallest and largest key, float64 sum of this warp's rows;
    // the warps' parts are summed in warp order, the same in every warp
    int n = 0;
    uint32_t kmin = kNone, kmax = 0u;
    double sum = 0.0;
    walk_pool(col, st, ln, C, ny, warp, live, [&](float v) {
        const uint32_t key = key_of(v);
        if (key != kNone) {
            ++n;
            kmin = min(kmin, key);
            kmax = max(kmax, key);
            sum += (double)v;
        }
    });
    s_cnt[0][warp][lane] = n;
    s_lo[warp][lane] = kmin;
    s_hi[warp][lane] = kmax;
    s_sum[warp][lane] = sum;
    __syncthreads();  // every warp's part of the pool's figures
    n = 0;
    kmin = kNone;
    kmax = 0u;
    sum = 0.0;
    for (int w = 0; w < kWarps; ++w) {
        n += s_cnt[0][w][lane];
        kmin = min(kmin, s_lo[w][lane]);
        kmax = max(kmax, s_hi[w][lane]);
        sum += s_sum[w][lane];
    }

    // rank k and fraction of position q*(n-1), as the tile kernel
    int k = 0;
    float frac = 0.0f;
    if (n > 0 && pct_int >= 0) {
        const int num = (n - 1) * pct_int;
        k = num / 100;
        frac = __fmul_rn((float)(num - k * 100), 0.01f);
    } else if (n > 0) {
        const float pos = __fmul_rn(q, __fsub_rn((float)n, 1.0f));
        k = max((int)floorf(pos), 0);
        frac = __fsub_rn(pos, (float)k);
    }

    // 2. the common-prefix skip, per cell; the block steps from the
    // highest bit any of its cells needs (the same in every warp)
    const uint32_t diff = kmin ^ kmax;
    const int b = (n > 0 && diff) ? 31 - __clz((int)diff) : -1;
    uint32_t lo = b < 0 ? kmin : kmin & ~((2u << b) - 1u);
    const int top = __reduce_max_sync(kAll, b + 1) - 1;

    // 3. MSB-first radix select, one pass over the rows a step: the
    // largest lo with #(key < lo) <= k. Missing keys (kNone) are below no
    // candidate. Counts alternate between two buffers, so that one
    // barrier a step keeps a warp from overwriting counts still read.
    int buf = 1;
    for (int s = top; s >= 0; --s, buf ^= 1) {
        const uint32_t cand = lo | (1u << s);
        int cnt = 0;
        walk_pool(col, st, ln, C, ny, warp, live,
                  [&](float v) { cnt += key_of(v) < cand; });
        s_cnt[buf][warp][lane] = cnt;
        __syncthreads();  // this step's counts
        int below = 0;
        for (int w = 0; w < kWarps; ++w) below += s_cnt[buf][w][lane];
        if (s <= b && below <= k) lo = cand;
    }

    // (k+1)-th order statistic: vk again when ties span position k+1,
    // else the smallest key strictly greater than lo
    int le = 0;
    uint32_t hik = kNone;
    walk_pool(col, st, ln, C, ny, warp, live, [&](float v) {
        const uint32_t key = key_of(v);
        le += key <= lo;
        if (key > lo) hik = min(hik, key);
    });
    s_cnt[buf][warp][lane] = le;
    s_hik[warp][lane] = hik;
    __syncthreads();  // every warp's le and hik
    if (warp != 0 || !live) return;
    le = 0;
    for (int w = 0; w < kWarps; ++w) {
        le += s_cnt[buf][w][lane];
        hik = min(hik, s_hik[w][lane]);
    }
    const size_t out = (size_t)d * C + c;
    if (n == 0) {
        th[out] = se[out] = NAN;
        return;
    }
    const float vk = key_float(lo);
    const float vk1 = (le > k + 1) ? vk : (hik != kNone ? key_float(hik) : vk);
    th[out] = __double2float_rn(__dadd_rn(
        (double)vk, __dmul_rn((double)frac, (double)__fsub_rn(vk1, vk))));
    se[out] = __double2float_rn(__ddiv_rn(sum, (double)n));
}

struct Args {
    const float* ts;
    const int* starts;
    const int* lens;
    float* th;
    float* se;
    int C, ndoy, ny, rmax, pct_int;
    float q;
    cudaStream_t stream;
};

template <int KPT>
int launch(const Args& a) {
    const size_t smem = (size_t)a.ny * a.rmax * kCells * sizeof(uint32_t);
    cudaError_t e = cudaFuncSetAttribute(
        doy_quantile_kernel<KPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.C + kCells - 1) / kCells, a.ndoy);
    doy_quantile_kernel<KPT><<<grid, kWarps * 32, smem, a.stream>>>(
        a.ts, a.starts, a.lens, a.th, a.se, a.C, a.ny, a.rmax, a.pct_int,
        a.q);
    return (int)cudaGetLastError();
}

// the smallest instance that holds kpt keys per lane
template <int K, int... More>
int dispatch(int kpt, const Args& a) {
    if (kpt <= K) return launch<K>(a);
    if constexpr (sizeof...(More) > 0) return dispatch<More...>(kpt, a);
    return (int)cudaErrorInvalidValue;
}

int launch_long(const Args& a) {
    const unsigned blocks = (unsigned)((a.C + kCells - 1) / kCells) * a.ndoy;
    doy_quantile_long_kernel<<<blocks, kWarps * 32, 0, a.stream>>>(
        a.ts, a.starts, a.lens, a.th, a.se, a.C, a.ndoy, a.ny, a.pct_int,
        a.q);
    return (int)cudaGetLastError();
}

}  // namespace

// ts: (Tp, C) float32 with every starts[i] + lens[i] <= Tp;
// starts/lens: (ndoy * ny,) int32; th/se: (ndoy, C) float32.
// pct_int >= 0 selects the exact integer rank for an integral percentile,
// otherwise q = pctile / 100 (rounded to float32) is used. Pools of up to
// ny * rmax = 1,816 rows are staged in the shared tile; longer ones take
// doy_quantile_long_kernel, which has no limit of its own.
extern "C" int xmhw_doy_quantile(const float* ts, const int* starts,
                                 const int* lens, float* th, float* se,
                                 int C, int ndoy, int ny, int rmax,
                                 int pct_int, float q, void* stream) {
    if (C == 0 || ndoy == 0) return 0;
    const Args a{ts, starts, lens, th, se, C, ndoy, ny, rmax, pct_int, q,
                 (cudaStream_t)stream};
    if ((long long)ny * rmax > kTileRows) return launch_long(a);
    const int kpt = (ny * rmax + 31) / 32;
    return dispatch<2, 4, 8, 11, 14, 16, 20, 24, 32, 40, 48, 57>(kpt, a);
}
