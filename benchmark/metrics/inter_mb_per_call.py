"""Intermediate arrays fetched from the card per ``detect(intermediate=
True)`` call, in MB (1e6 bytes): the program's ``inter_bytes`` over its
``inter_calls`` (``xmhw_tpu_torch.utils.counts``), from the process's
start, whose set-up runs the window's calls. A program without these
counters reads None."""

from benchmark.lib.counts import ratio


def read(run):
    r = ratio("inter_bytes", "inter_calls")
    return None if r is None else r / 1e6
