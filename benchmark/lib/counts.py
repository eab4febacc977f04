"""The program's counters (``xmhw_tpu_torch.utils.counts``), read by the
per-layer metrics. A program without them (an older checkout) reads
None."""

from __future__ import annotations


def program():
    """The program's counters since the process started, or None."""
    from xmhw_tpu_torch import utils

    read = getattr(utils, "counts", None)
    return read() if read is not None else None


def ratio(num, den):
    """Counter ``num`` over counter ``den``, or None where the program has
    no counters or ``den`` is still 0."""
    c = program()
    if not c or not c.get(den):
        return None
    return c.get(num, 0) / c[den]
