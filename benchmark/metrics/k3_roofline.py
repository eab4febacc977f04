"""Kernel 3's share of its roofline: the least time of its stage's
recorded calls (kernels/k3.py) over its kernels' device time, in %."""

from benchmark.lib.work import roofline


def read(run):
    return roofline(run, "k3")
