"""Bytes the pipeline stages onto the card (``pipeline.upload`` and
``parallel.mesh.replicated``), in MB (1e6 bytes) per shard-block
detected: the program's ``h2d_bytes`` over its ``detect_blocks``
(``xmhw_tpu_torch.utils.counts``), from the process's start, whose
set-up runs the window's calls."""

from benchmark.lib.counts import ratio


def read(run):
    r = ratio("h2d_bytes", "detect_blocks")
    return None if r is None else r / 1e6
