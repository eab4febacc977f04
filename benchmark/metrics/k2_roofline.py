"""Kernel 2's share of its roofline: the least time of its stage's
recorded calls (kernels/k2.py) over its kernels' device time, in %."""

from benchmark.lib.work import roofline


def read(run):
    return roofline(run, "k2")
