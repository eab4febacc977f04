"""The program's own spans in a traced stretch's chrome trace.

The port opens ``xmhw/<name>`` profiler ranges at the boundaries of its
layers (``xmhw_tpu_torch.utils.span``): the public calls, ``land_check``,
the union assembly, the pipeline's range tables, uploads, fetches and
detection passes. :func:`analyse` reduces them as :func:`trace.analyse`
reduces the benchmark's own ``bench/`` spans, inside the ``bench/stretch``
span and on the same clock, and without touching what that function
reads: each program span's intervals, its self time (less the program
spans inside it), the launches issued while it is the innermost program
span and the device time of the operations they launched (by correlation
id), the idle gaps named by the innermost program span open at their
middle, and the bytes of the traced copies. :func:`breakdown` gives the
contract's ``breakdown`` with each idle gap so named.
"""

from __future__ import annotations

from . import trace

PREFIX = "xmhw/"


def _window(events):
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == trace.PREFIX + "stretch"):
            w0 = float(e["ts"])
            return w0, w0 + float(e["dur"])
    raise ValueError("the trace has no bench/stretch span")


def _annotations(events, prefix, w0, w1):
    """(start, end, name less ``prefix``, thread) of each user range
    named ``prefix...`` that lies inside [w0, w1]."""
    out = []
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") != "user_annotation"
                or not str(e.get("name", "")).startswith(prefix)):
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if a >= w0 and b <= w1:
            out.append((a, b, e["name"][len(prefix):], e.get("tid")))
    return out


def _self_times(spans):
    """Seconds of each span less the spans of its thread directly inside
    it, summed by name."""
    out = {}
    by_tid = {}
    for s in spans:
        by_tid.setdefault(s[3], []).append(s)
    for ss in by_tid.values():
        ss = sorted(ss, key=lambda s: (s[0], -s[1]))
        child = [0.0] * len(ss)
        stack = []
        for k, (a, b, _, _) in enumerate(ss):
            while stack and ss[stack[-1]][1] <= a:
                stack.pop()
            if stack:
                child[stack[-1]] += b - a
            stack.append(k)
        for (a, b, name, _), c in zip(ss, child):
            out[name] = out.get(name, 0.0) + (b - a - c) / 1e6
    return out


def analyse(events):
    """Reduce a traced stretch's events to the program's spans.

    Returns ``window_s``; ``spans``: name -> [(start_s, end_s)] from the
    stretch's start; ``wall_s`` and ``self_s``: name -> seconds (self:
    less the program spans inside it, on its thread); ``launches``: name
    -> kernel launches while it was the innermost program span;
    ``device_s``: name -> device seconds of the operations launched then;
    ``gaps``: (seconds, name) of each idle stretch of each device, longest
    first, named ``xmhw/<name>`` by the innermost program span open at its
    middle, else by the innermost benchmark span as
    :func:`trace.analyse` names it, else None; ``idle_s``: name -> the
    gaps' seconds; ``copy_bytes``: {"HtoD": n, "DtoH": n, ...} of the
    traced copies, where the trace gives their bytes."""
    w0, w1 = _window(events)
    prog = _annotations(events, PREFIX, w0, w1)
    bench = [(a, b, n) for a, b, n, _ in
             _annotations(events, trace.PREFIX, w0, w1) if n != "stretch"]
    iv = [(a, b, n) for a, b, n, _ in prog]
    out = {"window_s": (w1 - w0) / 1e6, "spans": {}, "wall_s": {},
           "self_s": _self_times(prog), "launches": {}, "device_s": {},
           "gaps": [], "idle_s": {}, "copy_bytes": {}}
    for a, b, name in iv:
        out["spans"].setdefault(name, []).append(((a - w0) / 1e6,
                                                  (b - w0) / 1e6))
        out["wall_s"][name] = out["wall_s"].get(name, 0.0) + (b - a) / 1e6
    runtime = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launch_ts = [float(e["ts"]) for e in runtime
                 if "LaunchKernel" in str(e.get("name", ""))
                 and w0 <= float(e["ts"]) <= w1]
    for name in trace._innermost(iv, launch_ts):
        if name is not None:
            out["launches"][name] = out["launches"].get(name, 0) + 1
    corr = [e for e in runtime
            if (e.get("args") or {}).get("correlation") is not None]
    owner = dict(zip((e["args"]["correlation"] for e in corr),
                     trace._innermost(iv, [float(e["ts"]) for e in corr])))
    by_dev = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        args = e.get("args") or {}
        by_dev.setdefault(str(args.get("device", e.get("pid"))),
                          []).append((a, b))
        name = owner.get(args.get("correlation"))
        if name is not None:
            out["device_s"][name] = (out["device_s"].get(name, 0.0)
                                     + (b - a) / 1e6)
        if e["cat"] == "gpu_memcpy" and args.get("bytes") is not None:
            kind = next((k for k in ("HtoD", "DtoH", "DtoD")
                         if k in str(e.get("name", ""))), "other")
            out["copy_bytes"][kind] = (out["copy_bytes"].get(kind, 0)
                                       + int(args["bytes"]))
    gaps = []
    for ivs in by_dev.values():
        busy = trace._merge(ivs)
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps += [(b - a, a) for a, b in zip(edges[::2], edges[1::2])
                 if b > a]
    gaps.sort(key=lambda g: -g[0])
    mids = [a + d / 2 for d, a in gaps]
    names = [PREFIX + p if p is not None else b
             for p, b in zip(trace._innermost(iv, mids),
                             trace._innermost(bench, mids))]
    out["gaps"] = [(d / 1e6, n) for (d, _), n in zip(gaps, names)]
    for d, n in out["gaps"]:
        out["idle_s"][n] = out["idle_s"].get(n, 0.0) + d
    return out


def breakdown(an, prog, n=10):
    """:func:`trace.breakdown` of ``an`` with its idle gaps named by the
    innermost program span where one was open (``prog``: this module's
    :func:`analyse` of the same trace)."""
    out = trace.breakdown(an, n)
    out["idle_gaps"] = [[s or "none", d] for d, s in prog["gaps"][:n]]
    return out
