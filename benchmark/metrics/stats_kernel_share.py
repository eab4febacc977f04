"""Share of the stats layer's binned calls (``ops/block_stats.py``:
``event_bins`` and ``day_bins``) that launched a kernel rather than
running the plain torch route: the program's ``stats_kernel_calls`` over
its ``stats_calls`` (``xmhw_tpu_torch.utils.counts``), from the
process's start, whose set-up runs the window's calls. A program without
these counters reads None."""

from benchmark.lib.counts import ratio


def read(run):
    return ratio("stats_kernel_calls", "stats_calls")
