"""Running True-index bound: the CUDA kernel and its plain version.

* forward:  ``out[t] = max {s <= t : mask[s]}`` (-1 if none)
* backward: ``out[t] = min {s >= t : mask[s]}`` (T if none)

:func:`run_bound` launches ``csrc/run_bound.cu`` on a CUDA tensor and
runs :func:`run_bound_plain` on a CPU tensor; the two must agree bit for
bit. It replaces the TPU kernel ``xmhw_tpu/ops/pallas/run_bound.py:
run_bound``. No path of either package calls it: the JAX package keeps
its cummax/cummin scans as the default and the kernel as a tested
building block (``xmhw_tpu/ops/pallas/run_bound.py:13-18``), and so does
the port (``core/events.py``, ``csrc/rle.cu``).

The kernel splits time across the warps of a 32-cell block
(:func:`launch_config`); ``run_bound.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def run_bound_plain(mask, forward=True):
    """(T, C) int32 running bound of a (T, C) bool mask along time: a
    cummax of ``where(mask, t, -1)``, or a cummin over the flipped axis
    of ``where(mask, t, T)``."""
    T = mask.shape[0]
    t = torch.arange(T, dtype=torch.int32, device=mask.device).view(
        (T,) + (1,) * (mask.dim() - 1))
    if forward:
        return torch.cummax(torch.where(mask, t, -1), dim=0).values
    x = torch.flip(torch.where(mask, t, T), (0,))
    return torch.flip(torch.cummin(x, dim=0).values, (0,))


def run_bound(mask, forward=True):
    """The running bound of :func:`run_bound_plain`. A CUDA tensor must be
    a contiguous 2-D bool mask; CPU tensors run the plain version."""
    if not mask.is_cuda:
        return run_bound_plain(mask, forward)
    if mask.dtype != torch.bool or mask.dim() != 2 or not mask.is_contiguous():
        raise TypeError("run_bound kernel takes a contiguous 2-D bool mask, "
                        f"got {mask.dtype} {tuple(mask.shape)}")
    T, C = mask.shape
    out = torch.empty((T, C), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        err = _build.library().xmhw_run_bound(
            mask.data_ptr(), T, C, int(bool(forward)), out.data_ptr(),
            _build.stream_of(mask))
    _build.check(err, "run_bound")
    run_bound.launches += 1
    return out


run_bound.launches = 0


def launch_config(T):
    """The kernel's launch shape for T days: ``warps`` (time segments) and
    ``threads`` per block, ``days`` per segment and ``smem_bytes`` of
    shared memory per block. Builds the kernel library on first use."""
    vals = [ctypes.c_int() for _ in range(4)]
    _build.library().xmhw_run_bound_config(T, *map(ctypes.byref, vals))
    return dict(zip(("warps", "threads", "days", "smem_bytes"),
                    (v.value for v in vals)))
