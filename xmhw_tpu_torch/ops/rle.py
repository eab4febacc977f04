"""Event identification (RLE): the CUDA kernel and its plain version.

:func:`mhw_filter` launches ``csrc/rle.cu`` on a CUDA tensor and runs
:func:`mhw_filter_plain` (= :func:`core.events.mhw_filter`) on a CPU
tensor. It replaces the TPU kernel driven by
``xmhw_tpu/ops/pallas/rle.py:pallas_mhw_filter`` and must equal the
plain version bit for bit.
"""

from __future__ import annotations

import torch

from ..core import events
from . import _build

_INTERMEDIATE = ("event_id", "ev_start", "ev_end")


def mhw_filter_plain(bthresh, min_duration=5, join_gaps=True, max_gap=2,
                     day0_fillna_quirk=False, full=True):
    """:func:`core.events.mhw_filter`; without ``full`` the per-day
    ``event_id``/``ev_start``/``ev_end`` are left out, as the kernel
    does."""
    f = events.mhw_filter(bthresh, min_duration=min_duration,
                          join_gaps=join_gaps, max_gap=max_gap,
                          day0_fillna_quirk=day0_fillna_quirk)
    if not full:
        for k in _INTERMEDIATE:
            del f[k]
    return f


def mhw_filter(bthresh, min_duration=5, join_gaps=True, max_gap=2,
               day0_fillna_quirk=False, full=True):
    """Runs, minDuration filter and maxGap joining of a (T, C) bool
    exceedance mask; same outputs as :func:`mhw_filter_plain`.

    ``full=False`` skips the per-day ``event_id``/``ev_start``/``ev_end``
    (only the ``intermediate`` output reads them). CPU tensors run the
    plain version.
    """
    if not bthresh.is_cuda:
        return mhw_filter_plain(bthresh, min_duration, join_gaps, max_gap,
                                day0_fillna_quirk, full)
    if (bthresh.dtype != torch.bool or bthresh.dim() != 2
            or not bthresh.is_contiguous()):
        raise TypeError("rle kernel takes a contiguous 2-D bool mask, got "
                        f"{bthresh.dtype} {tuple(bthresh.shape)}")
    T, C = bthresh.shape
    dev = bthresh.device
    out = {
        "event_day": torch.empty((T, C), dtype=torch.bool, device=dev),
        "is_start": torch.empty((T, C), dtype=torch.bool, device=dev),
        "slot": torch.empty((T, C), dtype=torch.int32, device=dev),
        "n_events": torch.empty((C,), dtype=torch.int32, device=dev),
    }
    if full:
        for k in _INTERMEDIATE:
            out[k] = torch.empty((T, C), dtype=torch.int32, device=dev)
    inter = [out[k].data_ptr() if full else None for k in _INTERMEDIATE]
    err = _build.library().xmhw_rle(
        bthresh.data_ptr(), T, C, int(min_duration), int(bool(join_gaps)),
        int(max_gap), int(bool(day0_fillna_quirk)),
        out["event_day"].data_ptr(), out["is_start"].data_ptr(),
        out["slot"].data_ptr(), out["n_events"].data_ptr(), *inter,
        _build.stream_of(bthresh))
    _build.check(err, "rle")
    mhw_filter.launches += 1
    return out


mhw_filter.launches = 0
