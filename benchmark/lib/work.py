"""Kernel work recorded from the calls of a traced stretch, and the
roofline share it gives.

Each file ``benchmark/kernels/<kernel>.py`` names where the program calls
its stage (``CALLS``: (module, attribute) -> work count), the device
kernels that implement it (``TRACE_NAMES``, matched as substrings of the
trace's kernel names) and how many bytes and operations a call needs.
While a stretch is profiled, :class:`Recorder` wraps those attributes
and notes each call's work.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json

from . import spec


def peaks(kind):
    """The card's published peaks, or None for a card not in the table."""
    with open(spec.HERE / "lib" / "peaks.json") as f:
        return json.load(f).get(kind)


class Recorder:
    """Notes (bytes, operations) of each call of each kernel's stage while
    ``on()`` is true."""

    def __init__(self, kernels, on):
        self.kernels = {k: spec.module("kernels", k) for k in kernels}
        self.on = on
        self.calls = {k: [] for k in kernels}

    @contextlib.contextmanager
    def wrapped(self):
        saved = []
        for k, mod in self.kernels.items():
            for (mname, attr), count in mod.CALLS.items():
                m = importlib.import_module(mname)
                fn = getattr(m, attr)
                saved.append((m, attr, fn))
                setattr(m, attr, self._wrap(k, fn, count))
        try:
            yield self
        finally:
            for m, attr, fn in reversed(saved):
                setattr(m, attr, fn)

    def _wrap(self, k, fn, count):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if self.on() and getattr(args[0], "is_cuda", False):
                self.calls[k].append(count(*args, **kw))
            return fn(*args, **kw)
        return inner


def roofline(run, kernel, names=None):
    """Percent of the least time the card could take for the stage's
    recorded calls (the larger of bytes over peak bandwidth and operations
    over peak float32 rate, call by call) over the device time of its
    kernels in the stretch; None where nothing was recorded or traced, or
    the card has no entry in the peak table."""
    pk = run.peaks
    calls = run.work.calls.get(kernel) if run.work else None
    if not pk or not calls or run.trace is None:
        return None
    names = names or run.work.kernels[kernel].TRACE_NAMES
    dev_s = sum(s for name, cat, _, s, _ in run.trace["ops"]
                if cat == "kernel" and any(n in name for n in names))
    if dev_s <= 0:
        return None
    least = sum(max(b / pk["bytes_per_s"], o / pk["fp32_flops_per_s"])
                for b, o in calls)
    return 100.0 * least / dev_s
