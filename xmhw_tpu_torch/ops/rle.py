"""Event identification (RLE): the CUDA kernel and its plain versions.

:func:`mhw_filter` and :func:`event_counts` launch ``csrc/rle.cu`` on a
CUDA tensor and run :func:`mhw_filter_plain` / :func:`event_counts_plain`
(both :func:`core.events.mhw_filter`) on a CPU tensor. The kernel replaces
the TPU kernel driven by ``xmhw_tpu/ops/pallas/rle.py:pallas_mhw_filter``
and must equal the plain version bit for bit.

One kernel, four output sets, each written only when asked for:

* :func:`event_counts`: ``n_events`` alone, no (T, C) array (the counting
  pass that fixes the event capacity K);
* ``mhw_filter(slot=False, full=False)``: ``event_day``, ``is_start``,
  ``n_events`` (what the event scan reads);
* ``mhw_filter(full=False)``: adds ``slot``;
* ``mhw_filter()``: adds ``event_id``/``ev_start``/``ev_end`` (the
  ``intermediate`` output).

``mhw_filter.launches`` counts the kernel's launches by both functions,
``mhw_filter.by_mode`` those of each output set.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import events
from . import _build

_INTERMEDIATE = ("event_id", "ev_start", "ev_end")


def _keys(slot, full):
    if full and not slot:
        raise ValueError("full=True includes slot; pass slot=True")
    keys = ["event_day", "is_start", "n_events"]
    return keys + ["slot"] * slot + list(_INTERMEDIATE) * full


def mhw_filter_plain(bthresh, min_duration=5, join_gaps=True, max_gap=2,
                     day0_fillna_quirk=False, full=True, slot=True):
    """:func:`core.events.mhw_filter`, keeping the outputs that
    :func:`mhw_filter` writes for the same ``full`` and ``slot``."""
    f = events.mhw_filter(bthresh, min_duration=min_duration,
                          join_gaps=join_gaps, max_gap=max_gap,
                          day0_fillna_quirk=day0_fillna_quirk)
    return {k: f[k] for k in _keys(slot, full)}


def event_counts_plain(bthresh, min_duration=5, join_gaps=True, max_gap=2,
                       day0_fillna_quirk=False):
    """``{"n_events": (C,) int32}`` of :func:`core.events.mhw_filter`."""
    f = mhw_filter_plain(bthresh, min_duration, join_gaps, max_gap,
                         day0_fillna_quirk, full=False, slot=False)
    return {"n_events": f["n_events"]}


def _check(bthresh):
    if (bthresh.dtype != torch.bool or bthresh.dim() != 2
            or not bthresh.is_contiguous()):
        raise TypeError("rle kernel takes a contiguous 2-D bool mask, got "
                        f"{bthresh.dtype} {tuple(bthresh.shape)}")


def _launch(bthresh, out, min_duration, join_gaps, max_gap,
            day0_fillna_quirk):
    T, C = bthresh.shape
    lib = _build.library()
    n = lib.xmhw_rle_scratch(T, C)
    scratch = (torch.empty(n, dtype=torch.int32, device=bthresh.device)
               if n else None)
    ptr = [out[k].data_ptr() if k in out else None
           for k in ("event_day", "is_start", "slot", "n_events",
                     *_INTERMEDIATE)]
    err = lib.xmhw_rle(
        bthresh.data_ptr(), T, C, int(min_duration), int(bool(join_gaps)),
        int(max_gap), int(bool(day0_fillna_quirk)), *ptr,
        None if scratch is None else scratch.data_ptr(),
        _build.stream_of(bthresh))
    _build.check(err, "rle")
    mode = ("count" if "event_day" not in out else
            "days" if "slot" not in out else
            "slots" if "event_id" not in out else "full")
    mhw_filter.launches += 1
    mhw_filter.by_mode[mode] += 1
    return out


def mhw_filter(bthresh, min_duration=5, join_gaps=True, max_gap=2,
               day0_fillna_quirk=False, full=True, slot=True):
    """Runs, minDuration filter and maxGap joining of a (T, C) bool
    exceedance mask; same outputs as :func:`mhw_filter_plain`.

    ``full=False`` leaves out the per-day ``event_id``/``ev_start``/
    ``ev_end`` (only the ``intermediate`` output reads them), and
    ``slot=False`` (with ``full=False``) the per-day ``slot`` too. CPU
    tensors run the plain version.
    """
    if not bthresh.is_cuda:
        return mhw_filter_plain(bthresh, min_duration, join_gaps, max_gap,
                                day0_fillna_quirk, full, slot)
    keys = _keys(slot, full)
    _check(bthresh)
    T, C = bthresh.shape
    dev = bthresh.device
    out = {k: torch.empty((C,) if k == "n_events" else (T, C),
                          dtype=(torch.bool if k in ("event_day", "is_start")
                                 else torch.int32), device=dev)
           for k in keys}
    return _launch(bthresh, out, min_duration, join_gaps, max_gap,
                   day0_fillna_quirk)


def event_counts(bthresh, min_duration=5, join_gaps=True, max_gap=2,
                 day0_fillna_quirk=False):
    """``{"n_events": (C,) int32}``: the events per cell of
    :func:`mhw_filter`, with no per-day output. CPU tensors run the plain
    version."""
    if not bthresh.is_cuda:
        return event_counts_plain(bthresh, min_duration, join_gaps, max_gap,
                                  day0_fillna_quirk)
    _check(bthresh)
    out = {"n_events": torch.empty((bthresh.shape[1],), dtype=torch.int32,
                                   device=bthresh.device)}
    return _launch(bthresh, out, min_duration, join_gaps, max_gap,
                   day0_fillna_quirk)


def reset_launches():
    """Zero the launch count and the count of each output mode."""
    mhw_filter.launches = 0
    mhw_filter.by_mode = dict.fromkeys(("count", "days", "slots", "full"), 0)


reset_launches()


def launch_config(T):
    """The kernel's launch shape for T days: ``warps`` (time segments) and
    ``threads`` per block, ``days`` per segment and ``smem_bytes`` of
    shared memory per block. Builds the kernel library on first use."""
    vals = [ctypes.c_int() for _ in range(4)]
    _build.library().xmhw_rle_config(T, *map(ctypes.byref, vals))
    return dict(zip(("warps", "threads", "days", "smem_bytes"),
                    (v.value for v in vals)))
