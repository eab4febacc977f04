"""Kernel launches inside the span around ``pipeline.fused_stats`` (the
stats layer, core/stats.py), per cell block."""


def read(run):
    if (run.trace is None or "fused_stats" not in run.trace["spans"]
            or not run.trace["launches_all"]):
        return None
    return run.trace["launches"].get("fused_stats", 0) / run.blocks_traced()
