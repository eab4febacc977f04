"""Share of the API's land checks of a grid that compacted the ocean
cells into page-locked host memory, from which the cell blocks' uploads
are direct DMAs, rather than into pageable memory: the program's
``land_pinned_calls`` over its ``land_calls``
(``xmhw_tpu_torch.utils.counts``), from the process's start, whose
set-up runs the window's calls. A program without these counters reads
None."""

from benchmark.lib.counts import ratio


def read(run):
    return ratio("land_pinned_calls", "land_calls")
