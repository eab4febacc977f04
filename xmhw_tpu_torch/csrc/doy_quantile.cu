// Pooled day-of-year percentile threshold and mean climatology.
//
// Replaces the TPU kernel pallas_doy_clim (xmhw_tpu/ops/pallas/
// doy_quantile.py, kernel bodies _kernel and _kernel_batched). For every
// (doy, cell) it pools the +-w-day window of every year through the range
// tables starts/lens (core/calendar.build_window_ranges: one contiguous
// run of at most rmax rows per (doy, year)), drops NaN values, and returns
// the linear-interpolation percentile and the mean; NaN where the pool is
// empty.
//
// What bounds it on the H100: the selection, not device memory. The
// series is read about once from DRAM (neighbouring doys share 10 of 11
// window rows, so the rows stay in the 50 MB L2), but every (doy, cell)
// runs 33 counting passes over its pool of up to ny*rmax values (440 at
// 40 years): ~2e10 shared-memory reads per 4,096-cell block.
//
// Design: one thread per (doy, cell); a block is one doy and 32
// neighbouring cells, so every pooled row is one coalesced 128-byte read.
// Each thread keeps its own pool column in dynamic shared memory (layout
// [z][32]: lane-private, conflict-free, no block barrier needed), stored
// compacted as order-preserving uint32 keys with NaNs dropped on load, so
// the counting passes run over the valid values only. The pool needs
// ny*rmax*32*4 bytes (56 KB at 40 years): above the 48 KB default, hence
// cudaFuncSetAttribute. The 32 radix steps, the cnt_le/hik rule for the
// (k+1)-th order statistic and the exact integer rank for an integral
// pctile are those of core/clim._select_quantile; the unsigned key order
// equals the JAX package's signed-key order. The interpolation is rounded
// once, in float64, as the plain version does (see core/clim.py), with
// explicit _rn intrinsics so nvcc contracts nothing and the two agree to
// the bit. The TPU kernel's common-prefix skip is left out (an
// optimisation with bit-identical output).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCells = 32;   // threads (cells) per block
constexpr int kRows = 8;     // window rows loaded per batch

__device__ __forceinline__ uint32_t float_key(float x) {
    const uint32_t b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__global__ void doy_quantile_kernel(const float* __restrict__ ts,
                                    const int* __restrict__ starts,
                                    const int* __restrict__ lens,
                                    float* __restrict__ th,
                                    float* __restrict__ se,
                                    int C, int ny, int pct_int, float q) {
    extern __shared__ uint32_t pool[];  // [z][kCells]
    const int lane = threadIdx.x;
    const int c = blockIdx.x * kCells + lane;
    const int d = blockIdx.y;
    if (c >= C) return;

    // gather the pool: valid values only, keys in shared memory
    int n = 0;
    double sum = 0.0;  // float64, as the plain version
    for (int y = 0; y < ny; ++y) {
        const int s = starts[d * ny + y];
        const int len = lens[d * ny + y];
        for (int r0 = 0; r0 < len; r0 += kRows) {
            float v[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j)
                v[j] = (r0 + j < len)
                           ? __ldg(ts + (size_t)(s + r0 + j) * C + c)
                           : NAN;
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
                if (isfinite(v[j])) {
                    pool[n * kCells + lane] = float_key(v[j]);
                    sum += (double)v[j];
                    ++n;
                }
            }
        }
    }
    const size_t out = (size_t)d * C + c;
    if (n == 0) {
        th[out] = NAN;
        se[out] = NAN;
        return;
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

    // MSB-first radix select: the largest key lo with #(key < lo) <= k
    uint32_t lo = 0u;
    for (int b = 31; b >= 0; --b) {
        const uint32_t cand = lo | (1u << b);
        int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
        int z = 0;
        for (; z + 4 <= n; z += 4) {
            c0 += pool[(z + 0) * kCells + lane] < cand;
            c1 += pool[(z + 1) * kCells + lane] < cand;
            c2 += pool[(z + 2) * kCells + lane] < cand;
            c3 += pool[(z + 3) * kCells + lane] < cand;
        }
        for (; z < n; ++z) c0 += pool[z * kCells + lane] < cand;
        if (c0 + c1 + c2 + c3 <= k) lo = cand;
    }
    const float vk = key_float(lo);
    // (k+1)-th order statistic: vk again when ties span position k+1,
    // else the smallest key strictly greater than lo
    int cnt_le = 0;
    uint32_t hik = 0xFFFFFFFFu;
    for (int z = 0; z < n; ++z) {
        const uint32_t u = pool[z * kCells + lane];
        cnt_le += u <= lo;
        if (u > lo && u < hik) hik = u;
    }
    const float vk1 = (cnt_le > k + 1) ? vk
                      : (hik != 0xFFFFFFFFu ? key_float(hik) : vk);
    // vk + frac*(vk1 - vk) in float64 (the product is exact) and rounded
    // to float32, with _rn intrinsics that nvcc never contracts: the
    // plain version's arithmetic, bit for bit
    th[out] = __double2float_rn(__dadd_rn(
        (double)vk, __dmul_rn((double)frac, (double)__fsub_rn(vk1, vk))));
    se[out] = __double2float_rn(__ddiv_rn(sum, (double)n));
}

}  // namespace

// ts: (Tp, C) float32 with every starts[i] + lens[i] <= Tp;
// starts/lens: (ndoy * ny,) int32; th/se: (ndoy, C) float32.
// pct_int >= 0 selects the exact integer rank for an integral percentile,
// otherwise q = pctile / 100 (rounded to float32) is used.
extern "C" int xmhw_doy_quantile(const float* ts, const int* starts,
                                 const int* lens, float* th, float* se,
                                 int C, int ndoy, int ny, int rmax,
                                 int pct_int, float q, void* stream) {
    const size_t smem = (size_t)ny * rmax * kCells * sizeof(uint32_t);
    cudaError_t e = cudaFuncSetAttribute(
        doy_quantile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((C + kCells - 1) / kCells, ndoy);
    doy_quantile_kernel<<<grid, kCells, smem, (cudaStream_t)stream>>>(
        ts, starts, lens, th, se, C, ny, pct_int, q);
    return (int)cudaGetLastError();
}
