"""Share of the stats API's ``mhw_rank`` calls on a device whose ranks and
return periods landed in page-locked host memory, from which their copies
down are direct DMAs, rather than in pageable memory: the program's
``rank_pinned_calls`` over its ``rank_calls``
(``xmhw_tpu_torch.utils.counts``), from the process's start, whose set-up
runs the window's calls. A program without these counters reads None."""

from benchmark.lib.counts import ratio


def read(run):
    return ratio("rank_pinned_calls", "rank_calls")
