"""Page-locked host memory that the union grids built on the card ask
of PyTorch's caching host allocator, over the bytes of those grids: the
program's ``union_pinned_bytes`` over its ``union_card_bytes``
(``xmhw_tpu_torch.utils.counts``), from the process's start. 1.0 where
no grid is rounded up. A program without the ``union_pinned_bytes``
counter, or whose grids were never built on the card, reads None."""

from benchmark.lib.counts import program


def read(run):
    c = program()
    if not c or "union_pinned_bytes" not in c or not c.get(
            "union_card_bytes"):
        return None
    return c["union_pinned_bytes"] / c["union_card_bytes"]
