"""Share of ``detect()``'s union-layout assemblies whose grids were built
on the card and copied into page-locked host memory, rather than filled
and scattered on the host: the program's ``union_card_calls`` over its
``union_calls`` (``xmhw_tpu_torch.utils.counts``), from the process's
start, whose set-up runs the window's calls. A program without these
counters reads None."""

from benchmark.lib.counts import ratio


def read(run):
    return ratio("union_card_calls", "union_calls")
