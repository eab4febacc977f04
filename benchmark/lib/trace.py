"""Spans, the profiled stretch and the reduction of its chrome trace.

The spans are the benchmark's own: ``torch.profiler.record_function``
ranges named ``bench/<name>``, set from outside the program around the
port's functions (:func:`layer_spans`) and around each step. A traced run
profiles a stretch of the window (:class:`Stretch`), writes the trace
under ``TMPDIR``, reads it back and deletes it; :func:`analyse` reduces
it: device busy time (the union of kernels, copies and sets) per device,
device time by operation, the idle gaps with the span open at each, the
kernel launches inside each span, and device time charged to the span
that launched it (by the trace's correlation ids).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench/"


def span(name, on=True):
    """A ``bench/<name>`` range, or nothing when ``on`` is False."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def layer_spans(where, on=True):
    """Wrap attributes of the port's modules in spans while the context is
    open: ``where`` maps a span name to (module, attribute name). Restored
    on exit."""
    if not on:
        yield
        return
    saved = [(m, a, getattr(m, a)) for m, a in where.values()]

    def wrap(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner

    for name, (m, a) in where.items():
        setattr(m, a, wrap(name, getattr(m, a)))
    try:
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


class Stretch:
    """Profiles steps [first, first + count) of the window: call
    :meth:`before` ahead of each step and :meth:`after` behind it.
    ``sync`` waits for every device. After the stretch, :attr:`events`
    holds the trace's events and :attr:`steps` the steps profiled."""

    def __init__(self, first, count, sync):
        self.first, self.count, self.sync = first, count, sync
        self.prof = None
        self.events = None
        self.steps = 0
        self.active = False
        self._span = None

    def before(self, i):
        if i != self.first or self.events is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._span = span("stretch")
        self._span.__enter__()
        self.active = True

    def after(self, i):
        if not self.active:
            return
        self.steps += 1
        if i + 1 == self.first + self.count:
            self.close()

    def close(self):
        """End the stretch early (the window closed inside it)."""
        if not self.active:
            return
        self.sync()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name, n=120):
    name = str(name)
    return name if len(name) <= n else name[:n - 3] + "..."


def _open_at(spans, times):
    """The names of the spans open at each of ``times`` (sorted or not),
    outermost first; spans nest, as ranges of one thread do."""
    order = sorted(range(len(times)), key=lambda k: times[k])
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [None] * len(times)
    stack, j = [], 0
    for k in order:
        t = times[k]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = tuple(x[2] for x in stack)
    return out


def _innermost(spans, times):
    return [o[-1] if o else None for o in _open_at(spans, times)]


def analyse(events):
    """Reduce a chrome trace to the numbers the per-layer metrics read.

    Inside the ``bench/stretch`` span: ``window_s``; ``busy_s`` per device
    (union of device operations); ``ops``: (name, category, device,
    seconds, span) of every device operation, its span the innermost bench
    span open when the host launched it (by correlation id; None for an
    operation whose launch the trace does not hold); ``spans``: name ->
    [(start_s, end_s)]; ``launches``: span name -> kernel launches issued
    while it was the innermost open span or inside it (by name: every
    span open at the launch counts it); ``gaps``: (seconds, span open at
    the gap's middle) of each idle stretch of each device, longest first.
    Times are seconds from the stretch's start."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    win = [s for s in spans if s["name"] == PREFIX + "stretch"]
    if not win:
        raise ValueError("the trace has no bench/stretch span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    iv = [(float(s["ts"]), float(s["ts"]) + float(s["dur"]),
           s["name"][len(PREFIX):]) for s in spans
          if s["name"] != PREFIX + "stretch"]
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in str(e.get("name", ""))
                and w0 <= float(e["ts"]) <= w1]
    runtime = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and (e.get("args") or {}).get("correlation") is not None]
    owner = dict(zip(
        (e["args"]["correlation"] for e in runtime),
        _innermost(iv, [float(e["ts"]) for e in runtime])))
    out = {"window_s": (w1 - w0) / 1e6, "busy_s": {}, "ops": [],
           "spans": {}, "launches": {}, "gaps": []}
    for a, b, name in iv:
        if a >= w0 and b <= w1:
            out["spans"].setdefault(name, []).append(((a - w0) / 1e6,
                                                      (b - w0) / 1e6))
    for names in _open_at(iv, [float(e["ts"]) for e in launches]):
        for name in set(names):
            out["launches"][name] = out["launches"].get(name, 0) + 1
    out["launches_all"] = len(launches)
    by_dev = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        args = e.get("args") or {}
        dev = str(args.get("device", e.get("pid")))
        by_dev.setdefault(dev, []).append((a, b))
        out["ops"].append((_short(e.get("name")), e["cat"], dev,
                           (b - a) / 1e6, owner.get(args.get("correlation"))))
    gaps = []
    for dev, ivs in sorted(by_dev.items()):
        busy = _merge(ivs)
        out["busy_s"][dev] = sum(b - a for a, b in busy) / 1e6
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps += [(b - a, a) for a, b in zip(edges[::2], edges[1::2])
                 if b > a]
    gaps.sort(key=lambda g: -g[0])
    names = _innermost(iv, [a + d / 2 for d, a in gaps])
    out["gaps"] = [(d / 1e6, n) for (d, _), n in zip(gaps, names)]
    return out


def breakdown(an, n=10):
    """The contract's ``breakdown``: the device operations with the most
    time and the longest idle gaps, each named by the span open at it."""
    total = {}
    for name, _, _, s, _ in an["ops"]:
        total[name] = total.get(name, 0.0) + s
    ops = sorted(total.items(), key=lambda x: -x[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[s or "none", d] for d, s in an["gaps"][:n]]}
