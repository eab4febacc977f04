"""Year-block statistics of a cell block: the CUDA kernels and their plain
versions.

:func:`event_bins` and :func:`day_bins` are the stats layer's two binned
reductions, the halves of ``block_average`` (reference:
xmhw/stats.py:322-428). On CUDA tensors each launches
``csrc/block_stats.cu`` once; its float tensors must then be float32 on
one device, else it raises TypeError. CPU tensors run the plain versions
(:func:`event_bins_plain`, :func:`day_bins_plain`: the slot bins or the
category series as tensors, then :func:`core.stats.binned_event_stats`
or :func:`core.stats.binned_day_stats`). Which of the two a caller runs
is the caller's choice, by the dtype rule of
``core.pipeline.use_kernels_for`` (:func:`bins_for`), as for every
other kernel of the port. Both give the same bits: the kernels add each
output's terms in index order from 0.0, as the plain versions' running
sums do. There is no TPU kernel behind them: the JAX package leaves
these reductions to XLA, which fuses them.

Every call counts ``stats_calls``, each that launched a kernel
``stats_kernel_calls`` (:func:`xmhw_tpu_torch.utils.counts`);
``event_bins.launches`` and ``day_bins.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.stats import (EVENT_AGGS, EVENT_VARS, binned_day_stats,
                          binned_event_stats, category_index, day_stat_names)
from ..utils import count
from . import _build


def _ptr(t):
    """A tensor's device address for ctypes, or NULL for None."""
    return None if t is None else t.data_ptr()


def _on(dev, what, t, dtype=None):
    """``t`` on ``dev`` (int32 for an integer table), or TypeError: a CUDA
    tensor the kernel cannot launch on."""
    if t.device != dev or (dtype is None and t.is_floating_point()) or (
            dtype is not None and t.dtype != dtype):
        raise TypeError(f"block_stats kernel: {what} must be "
                        f"{dtype or 'an integer tensor'} on {dev}, got "
                        f"{t.dtype} on {t.device}")
    return t.to(torch.int32).contiguous() if dtype is None else t.contiguous()


def bins_for(kernels):
    """(event_bins, day_bins), or their plain versions where ``kernels`` is
    False: the caller's choice by ``core.pipeline.use_kernels_for``."""
    if kernels:
        return event_bins, day_bins
    return event_bins_plain, day_bins_plain


def event_bins_plain(values, key, nbins, lut=None, negate=()):
    """Plain version of :func:`event_bins`: each slot's bin and validity as
    tensors, then :func:`core.stats.binned_event_stats`."""
    count("stats_calls")
    b = key if lut is None else lut[torch.clamp(
        key, 0, lut.shape[0] - 1).long()]
    valid = (key >= 0) & (b >= 0)
    neg = set(negate)
    if neg or not torch.is_tensor(values):
        values = torch.stack([-v if i in neg else v
                              for i, v in enumerate(values)])
    return binned_event_stats(values, torch.clamp(b, 0, nbins - 1), valid,
                              nbins)


def event_bins(values, key, nbins, lut=None, negate=()):
    """The year-bin aggregations of an event table: dict EVENT_AGGS name
    -> (nbins, C), :func:`core.stats.binned_event_stats`' output.

    ``values``: the 13 EVENT_VARS as a (13, K, C) tensor or a sequence of
    (K, C) tensors; ``negate``: indexes of the variables to negate first
    (the cold flip). ``key``: (K, C) int. Slot (k, c) lies in year bin
    ``lut[clamp(key[k, c], 0, len(lut) - 1)]`` (the fused stage: the start
    day's bin, ``lut`` = ybod) or, without ``lut``, bin ``key[k, c]``; in
    none where the key or that bin is negative; bins past ``nbins - 1``
    count in the last. Slots need not be sorted by bin. CPU tensors run
    the plain version; on the card the values must be float32.
    """
    if not values[0].is_cuda:
        return event_bins_plain(values, key, nbins, lut, negate)
    dev = values[0].device
    vals = [_on(dev, f"value {i}", v, torch.float32)
            for i, v in enumerate(values)]
    K, C = vals[0].shape
    if len(vals) != len(EVENT_VARS) or any(v.shape != (K, C) for v in vals):
        raise TypeError(f"block_event kernel: {len(EVENT_VARS)} (K, C) "
                        f"variables, got {[tuple(v.shape) for v in vals]}")
    key = _on(dev, "key", key)
    if key.shape != (K, C):
        raise TypeError(f"block_event kernel: key must be ({K}, {C}), got "
                        f"{tuple(key.shape)}")
    if lut is not None:
        lut = _on(dev, "lut", lut)
        if lut.dim() != 1 or lut.numel() == 0:
            raise TypeError("block_event kernel: lut must be a non-empty "
                            f"1-D table, got {tuple(lut.shape)}")
    out = torch.empty((len(EVENT_AGGS), nbins, C), dtype=torch.float32,
                      device=dev)
    ptrs = (ctypes.c_void_p * len(vals))(*(v.data_ptr() for v in vals))
    neg = sum(1 << i for i in set(negate))
    with torch.cuda.device(dev):
        err = _build.library().xmhw_block_event_stats(
            ctypes.addressof(ptrs), neg, key.data_ptr(),
            _ptr(lut),
            0 if lut is None else lut.numel(), K, C, nbins,
            out.data_ptr(), _build.stream_of(out))
    _build.check(err, "block_event_stats")
    event_bins.launches += 1
    count("stats_calls")
    count("stats_kernel_calls")
    return {name: out[r] for r, (name, _, _) in enumerate(EVENT_AGGS)}


event_bins.launches = 0


@functools.lru_cache(maxsize=16)
def _edges_on(edges, dev):
    """A day-edge tuple as an int32 tensor on ``dev``, uploaded once."""
    return torch.tensor(edges, dtype=torch.int32, device=dev)


def day_bins_plain(ts, edges, th=None, se=None, doy_pos=None,
                   count_nans=False):
    """Plain version of :func:`day_bins`: the (T, C) category series, then
    :func:`core.stats.binned_day_stats`."""
    count("stats_calls")
    cats = None
    if th is not None:
        pos = doy_pos.long()
        cats = category_index(ts, th[pos], se[pos])
    return binned_day_stats(ts, cats, edges, with_cats=th is not None,
                            count_nans=count_nans)


def day_bins(ts, edges, th=None, se=None, doy_pos=None, count_nans=False):
    """The per-day year-bin statistics of a series: dict name -> (nbins,
    C), :func:`core.stats.binned_day_stats`' output.

    ``ts``: (T, C) float; ``edges``: nbins + 1 time indexes, bin b the days
    ``edges[b] .. edges[b+1] - 1``. With ``th``/``se`` ((ndoy, C)
    climatologies) and ``doy_pos`` ((T,) int rows of them), the category
    day counts of ``category_index(ts, th[doy_pos], se[doy_pos])``; with
    ``count_nans``, ``nan_days``. CPU tensors run the plain version; on
    the card ``ts``, ``th`` and ``se`` must be float32.
    """
    if not ts.is_cuda:
        return day_bins_plain(ts, edges, th, se, doy_pos, count_nans)
    dev = ts.device
    ts = _on(dev, "ts", ts, torch.float32)
    T, C = ts.shape
    cats = th is not None
    if cats:
        th = _on(dev, "th", th, torch.float32)
        se = _on(dev, "se", se, torch.float32)
        doy_pos = _on(dev, "doy_pos", doy_pos)
        if (th.dim() != 2 or th.shape[1] != C or se.shape != th.shape
                or doy_pos.shape != (T,)):
            raise TypeError(
                f"block_day kernel: th/se must be (ndoy, {C}) and doy_pos "
                f"({T},), got {tuple(th.shape)}, {tuple(se.shape)}, "
                f"{tuple(doy_pos.shape)}")
    names = day_stat_names(cats, count_nans)
    edges = tuple(int(x) for x in edges)
    if min(edges) < 0 or max(edges) > T:
        raise ValueError(f"block_day kernel: edges must lie in [0, {T}], "
                         f"got {edges}")
    nbins = len(edges) - 1
    out = torch.empty((len(names), nbins, C), dtype=torch.float32,
                      device=dev)
    e = _edges_on(edges, dev)
    with torch.cuda.device(dev):
        err = _build.library().xmhw_block_day_stats(
            ts.data_ptr(), _ptr(th), _ptr(se), _ptr(doy_pos), e.data_ptr(),
            C, nbins, int(bool(count_nans)), out.data_ptr(),
            _build.stream_of(ts))
    _build.check(err, "block_day_stats")
    day_bins.launches += 1
    count("stats_calls")
    count("stats_kernel_calls")
    return {name: out[r] for r, name in enumerate(names)}


day_bins.launches = 0
