"""Pooled day-of-year percentile + mean: the CUDA kernel and its plain
version.

:func:`doy_quantile` launches ``csrc/doy_quantile.cu`` on a CUDA tensor
and runs :func:`doy_quantile_plain` on a CPU tensor. It replaces the TPU
kernel ``xmhw_tpu/ops/pallas/doy_quantile.py:pallas_doy_clim``, with the
same inputs: a series padded with ``rmax`` trailing NaN rows and the flat
``(ndoy * ny,)`` range tables of ``core.calendar.build_window_ranges``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clim import pooled_clim
from . import _build

# A block of the kernel stages the pools of 32 cells (ny*rmax 4-byte keys
# each) in shared memory, 232,448 B at most on the H100: pools of up to
# TILE_ROWS rows. Longer pools take the kernel's second route, which reads
# them from the series pass by pass (csrc/doy_quantile.cu, kTileRows).
TILE_ROWS = 232_448 // (32 * 4)


def route(ny, rmax):
    """The kernel's route for pools of ny * rmax rows: "tile" (staged in
    shared memory) or "long" (read from the series in every pass)."""
    return "tile" if ny * rmax <= TILE_ROWS else "long"


def gather_pool(ts_padded, starts, lens, ndoy, ny, rmax):
    """The (ndoy, ny*rmax, C) pools through the range tables: row
    y*rmax + r of pool d is day r of year y's window, NaN past the
    window's length."""
    dev = ts_padded.device
    r = torch.arange(rmax, dtype=torch.int32, device=dev)
    rows = starts.view(ndoy, ny, 1) + r
    ok = r < lens.view(ndoy, ny, 1)
    rows = torch.where(ok, rows, 0).view(ndoy, ny * rmax).long()
    return torch.where(ok.view(ndoy, ny * rmax, 1), ts_padded[rows],
                       torch.nan)


def doy_quantile_plain(ts_padded, starts, lens, ndoy, ny, rmax, pctile=90):
    """Plain torch version: :func:`gather_pool`, then the radix select
    (float32) or masked sort (float64) and masked mean of
    :func:`core.clim.pooled_clim` over the finite values."""
    pool = gather_pool(ts_padded, starts, lens, ndoy, ny, rmax)
    return pooled_clim(pool, torch.isfinite(pool), pctile)


def doy_quantile(ts_padded, starts, lens, ndoy, ny, rmax, pctile=90):
    """Percentile threshold and mean per (doy, cell).

    ts_padded: (Tp, C) float32 with every ``starts[i] + lens[i] <= Tp``
    (the series plus ``rmax`` trailing NaN rows); starts/lens: flat
    (ndoy*ny,) int32. Returns (thresh, seas), each (ndoy, C), NaN where
    a pool is empty. Any pool length: pools of up to TILE_ROWS rows are
    staged in shared memory, longer ones read from the series
    (:func:`route`). CPU tensors run the plain version.
    """
    if not ts_padded.is_cuda:
        return doy_quantile_plain(ts_padded, starts, lens, ndoy, ny, rmax,
                                  pctile)
    if (ts_padded.dtype != torch.float32 or ts_padded.dim() != 2
            or not ts_padded.is_contiguous()):
        raise TypeError("doy_quantile kernel takes a contiguous 2-D float32 "
                        f"series, got {ts_padded.dtype} "
                        f"{tuple(ts_padded.shape)}")
    for name, t in (("starts", starts), ("lens", lens)):
        if (t.device != ts_padded.device or t.dtype != torch.int32
                or t.numel() != ndoy * ny or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous ({ndoy * ny},) "
                             f"int32 on {ts_padded.device}")
    C = ts_padded.shape[1]
    th = torch.empty((ndoy, C), dtype=torch.float32, device=ts_padded.device)
    se = torch.empty_like(th)
    pct_int = int(pctile) if float(pctile).is_integer() else -1
    q = float(np.float32(pctile / 100.0))
    with torch.cuda.device(ts_padded.device):
        err = _build.library().xmhw_doy_quantile(
            ts_padded.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            th.data_ptr(), se.data_ptr(), C, ndoy, ny, rmax, pct_int, q,
            _build.stream_of(ts_padded))
    _build.check(err, "doy_quantile")
    doy_quantile.launches += 1
    doy_quantile.by_route[route(ny, rmax)] += 1
    return th, se


def reset_launches():
    """Zero :func:`doy_quantile`'s launch count and its count by route."""
    doy_quantile.launches = 0
    doy_quantile.by_route = {"tile": 0, "long": 0}


reset_launches()
