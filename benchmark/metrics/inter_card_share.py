"""Share of ``detect(intermediate=True)`` calls whose intermediate grids
were built on the card and copied into page-locked host memory, rather
than fetched as (time, cell) arrays and scattered on the host: the
program's ``inter_card_calls`` over its ``inter_calls``
(``xmhw_tpu_torch.utils.counts``), from the process's start, whose set-up
runs the window's calls. A program without these counters reads None."""

from benchmark.lib.counts import ratio


def read(run):
    return ratio("inter_card_calls", "inter_calls")
