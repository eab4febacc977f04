"""Device time of every kernel other than kernels 1-3 (the torch glue of
clim.py, features_scan.py and events.py), in ms per cell block."""

from benchmark.lib import spec


def read(run):
    if run.trace is None or not run.traced_steps or not run.trace["ops"]:
        return None
    names = [n for k in ("k1", "k2", "k3")
             for n in spec.module("kernels", k).TRACE_NAMES]
    s = sum(sec for name, cat, _, sec, _ in run.trace["ops"]
            if cat == "kernel" and not any(n in name for n in names))
    return 1e3 * s / run.blocks_traced()
