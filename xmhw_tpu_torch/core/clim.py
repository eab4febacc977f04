"""Climatology in torch: windowed doy quantile/mean, feb29, smoothing.

Port of :mod:`xmhw_tpu.core.clim` (reference: xmhw/identify.py:184-270,
137-181). All cells are computed at once on dense ``(time, cell)`` tensors:

* a static int32 gather table (built once on the host,
  :func:`xmhw_tpu_torch.core.calendar.build_window_index`) maps each doy
  bucket to its pooled time indices, and one gather produces the dense
  ``(ndoy, Z, cell)`` pool;
* float64 pools take a masked sort plus linear interpolation (exact
  parity with numpy/xarray ``quantile``); float32 pools take a sort-free
  32-step radix select on order-preserving int32 keys;
* the Feb-29 patch averages doys 59..61 and the circular running mean is
  a sum of rolls, with the float adds in the same order as the JAX
  package so float32 thresholds agree to the ulp.

The fused CUDA kernel (:mod:`xmhw_tpu_torch.ops.doy_quantile`) replaces
:func:`doy_clim` for float32 on the GPU; :func:`finish_clim` is shared by
both paths.
"""

from __future__ import annotations

import torch

_I32_MAX = 0x7FFFFFFF
_SIGN = -0x80000000


def _const(v, dt, like):
    """A 0-dim ``dt`` tensor on ``like``'s device, so that a scalar
    operand is rounded to ``dt`` before the op, as in the JAX package."""
    return torch.tensor(v, dtype=dt, device=like.device)


def ordered_sum(x, dim, dtype=None):
    """Sum along ``dim`` in index order, one running sum per output.

    torch's ``sum`` vectorises across the other axes, so an output's bits
    depend on how many outputs lie beside it: on the width of a cell
    block, or of a mesh shard. A running sum (``cumsum``) adds each
    output's terms in index order whatever the width, so a cell mesh run
    equals the single-device run bit for bit."""
    if x.shape[dim] == 0:
        return x.sum(dim=dim, dtype=dtype)
    return torch.cumsum(x, dim=dim, dtype=dtype).select(dim, -1).clone()


def _float_key(x):
    """Monotonic float32 -> SIGNED int32 key (total order).

    The unsigned key u (set the sign bit of positives, bitwise-not
    negatives) carried in the order-preserving signed form
    r = u ^ 0x80000000, as in the JAX package.
    """
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, ~bits ^ _SIGN, bits)


def _key_to_float(r):
    bits = torch.where(r >= 0, r, ~(r ^ _SIGN))
    return bits.contiguous().view(torch.float32)


def _quantile_rank_frac(n, pctile, dt):
    """Order-statistic rank k and interpolation fraction for position
    q*(n-1), q = pctile/100.

    For integral ``pctile`` the position is computed EXACTLY in int32 —
    pctile*(n-1) = 100*k + rem — so near-integer positions never floor
    to the adjacent rank. Non-integral percentiles use float arithmetic
    in ``dt``.
    """
    n = n.to(torch.int32)
    if float(pctile).is_integer():
        num = (n - 1) * int(pctile)
        k = torch.clamp(torch.div(num, 100, rounding_mode="floor"), min=0)
        # times 0.01, not / 100: the TPU kernel's form, and what XLA
        # simplifies the JAX package's division to
        frac = torch.clamp(num - k * 100, min=0).to(dt) * _const(0.01, dt,
                                                                   n)
    else:
        pos = _const(pctile / 100.0, dt, n) * (n.to(dt) - 1.0)
        k = torch.clamp(torch.floor(pos).to(torch.int32), min=0)
        frac = pos - k.to(dt)
    return k, frac


def _select_quantile(vals, mask, pctile):
    """Linear-interpolation quantile via radix select (sort-free).

    Finds the order statistics k and k+1 of the masked multiset by a
    greedy MSB-first bisection on the int32 key space (32 counting
    passes) and interpolates, including tied values spanning the k/k+1
    boundary. vals/mask: (D, Z, C); returns (D, C).
    """
    dt = vals.dtype
    key = torch.where(mask, _float_key(vals), _I32_MAX)
    n = mask.sum(dim=1, dtype=torch.int32)
    k, frac = _quantile_rank_frac(n, pctile, dt)

    # start at INT32_MIN (all-zero unsigned pattern) and try setting each
    # unsigned bit; unsigned bit 31 toggles the signed sign bit
    lo = torch.full(n.shape, _SIGN, dtype=torch.int32, device=vals.device)
    for b in range(31, -1, -1):
        cand = lo ^ _SIGN if b == 31 else lo | (1 << b)
        cnt = (key < cand[:, None, :]).sum(dim=1, dtype=torch.int32)
        lo = torch.where(cnt <= k, cand, lo)
    vk = _key_to_float(lo).to(dt)
    # (k+1)-th order statistic: with ties spanning position k+1 it EQUALS
    # vk; otherwise it is the smallest key strictly greater than lo
    cnt_le = (key <= lo[:, None, :]).sum(dim=1, dtype=torch.int32)
    hik = torch.where(key > lo[:, None, :], key, _I32_MAX).amin(dim=1)
    vk1 = torch.where(cnt_le > k + 1, vk,
                      torch.where(hik != _I32_MAX,
                                  _key_to_float(hik).to(dt), vk))
    # vk + frac*(vk1 - vk) rounded as XLA's fused multiply-add rounds it
    # in the JAX package: the float64 product of two float32 values is
    # exact, so only the sum is rounded (to float64, then float32; the
    # double rounding can differ from one FMA rounding only when the
    # float64 sum lands on a float32 midpoint). Kernel 1 does the same.
    out = (vk.double() + frac.double() * (vk1 - vk).double()).to(dt)
    return torch.where(n > 0, out, torch.nan)


def _masked_sort(vals, mask):
    """Sort ``vals`` ascending along axis 1 with invalid entries last.

    Returns (sorted_vals, n_valid)."""
    svals = torch.sort(torch.where(mask, vals, torch.inf), dim=1).values
    return svals, mask.sum(dim=1, dtype=torch.int32)


def _interp_quantile(svals, n, pctile):
    """Linear-interpolation quantile of pre-sorted values (numpy's
    default 'linear' method, reference: identify.py:233-235)."""
    lo, frac = _quantile_rank_frac(n, pctile, svals.dtype)
    hi = lo + (frac > 0).to(torch.int32)
    zmax = svals.shape[1] - 1
    lo = torch.clamp(lo, 0, zmax).long()
    hi = torch.clamp(hi, 0, zmax).long()
    vlo = torch.gather(svals, 1, lo[:, None, :])[:, 0, :]
    vhi = torch.gather(svals, 1, hi[:, None, :])[:, 0, :]
    out = vlo + frac * (vhi - vlo)
    return torch.where(n > 0, out, torch.nan)


def pooled_clim(vals, mask, pctile):
    """Percentile threshold and mean of a masked (D, Z, C) pool.

    float64 pools take the comparator sort (exact reference parity),
    other dtypes the radix select. Returns (thresh, seas), each (D, C),
    NaN where a pool is empty.
    """
    if vals.dtype == torch.float64:
        svals, n = _masked_sort(vals, mask)
        thresh = _interp_quantile(svals, n, pctile)
    else:
        n = mask.sum(dim=1, dtype=torch.int32)
        thresh = _select_quantile(vals, mask, pctile)
    # the mean is summed and divided in float64 and rounded once, so that
    # kernel 1 (which sums in another order) agrees with it to the ulp
    ssum = ordered_sum(torch.where(mask, vals, 0.0), 1, torch.float64)
    seas = torch.where(n > 0, ssum / torch.clamp(n, min=1), torch.nan)
    return thresh, seas.to(vals.dtype)


def doy_clim(ts, gidx, pctile):
    """Windowed day-of-year percentile threshold and mean climatology.

    ts: (T, C) float tensor, NaN = missing; gidx: (ndoy, Z) int tensor of
    pooled time indices, -1 padded. Returns (thresh, seas), each
    (ndoy, C).
    """
    pos_ok = gidx >= 0
    safe_idx = torch.where(pos_ok, gidx, 0).long()
    vals = ts[safe_idx]  # (ndoy, Z, C)
    mask = pos_ok[..., None] & torch.isfinite(vals)
    return pooled_clim(vals, mask, pctile)


def feb29_patch(clim):
    """Overwrite doy 60 (row 59) with the nanmean of doys 59..61
    (reference: identify.py:137-151). Returns a new tensor."""
    rows = clim[58:61]
    m = torch.isfinite(rows)
    z = torch.where(m, rows, 0.0)
    s = z[0] + z[1] + z[2]
    c = m.sum(dim=0, dtype=torch.int32)
    mean = torch.where(c > 0, s / torch.clamp(c, min=1).to(clim.dtype),
                       torch.nan)
    out = clim.clone()
    out[59] = mean
    return out


def runavg_circular(clim, w):
    """Periodic centered running mean of odd width ``w`` on the doy axis,
    NaN-propagating (reference: identify.py:154-181). The adds run in
    the JAX package's order, k = -half .. half, and the division is a
    product with the rounded reciprocal, as XLA compiles the JAX
    package's ``acc / w``: float32 results then agree to the bit."""
    half = (w - 1) // 2
    acc = torch.zeros_like(clim)
    for k in range(-half, half + 1):
        acc = acc + torch.roll(clim, -k, dims=0)
    return acc * _const(1.0 / w, clim.dtype, clim)


def finish_clim(thresh, seas, smooth=True, smooth_w=31, patch_feb29=True):
    """Feb-29 patch then circular smoothing of both climatologies."""
    if patch_feb29:
        thresh = feb29_patch(thresh)
        seas = feb29_patch(seas)
    if smooth:
        thresh = runavg_circular(thresh, smooth_w)
        seas = runavg_circular(seas, smooth_w)
    return thresh, seas


def clim_kernel(ts, gidx, pctile=90, smooth=True, smooth_w=31,
                patch_feb29=True):
    """Pooling -> quantile/mean -> feb29 -> circular smoothing for one
    cell block (reference: xmhw.py:250-307)."""
    thresh, seas = doy_clim(ts, gidx, pctile)
    return finish_clim(thresh, seas, smooth, smooth_w, patch_feb29)
