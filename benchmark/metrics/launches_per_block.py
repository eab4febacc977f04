"""Kernel launches the host issued inside each step's span, per cell
block (the trace's runtime events)."""


def read(run):
    if (run.trace is None or not run.traced_steps
            or not run.trace["launches_all"]):
        return None
    return run.trace["launches"].get("step", 0) / run.blocks_traced()
