"""Detection passes over the cell blocks the pipeline detects: the
counting pass that fixes K plus each detection run, reruns after an
overflow included, per shard-block (the program's ``detect_passes`` over
its ``detect_blocks``, ``xmhw_tpu_torch.utils.counts``). The counters run
from the process's start: set-up's calls are the window's calls, so the
ratio is the window's unless a block reran in one and not the other. A
grid of three blocks with no rerun reads 4/3."""

from benchmark.lib.counts import ratio


def read(run):
    return ratio("detect_passes", "detect_blocks")
