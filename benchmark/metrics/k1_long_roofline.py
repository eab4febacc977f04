"""Kernel 1's share of its roofline on its long route (pools past its
shared-memory tile), in %; read only where the program's route counter
shows every launch of the window on the long route."""

from benchmark.lib.work import roofline


def read(run):
    c = run.counters
    if not c.get("doy_quantile.long") or c.get("doy_quantile.tile"):
        return None
    return roofline(run, "k1", names=("doy_quantile_long_kernel",))
