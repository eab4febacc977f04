"""Device time of the operations launched inside the span around
``pipeline.fused_stats`` (matched by the trace's correlation ids), in ms
per cell block."""


def read(run):
    if (run.trace is None or "fused_stats" not in run.trace["spans"]
            or not run.trace["ops"]):
        return None
    s = sum(sec for _, _, _, sec, owner in run.trace["ops"]
            if owner == "fused_stats")
    return 1e3 * s / run.blocks_traced()
