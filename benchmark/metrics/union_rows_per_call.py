"""Rows of the events dimension per union-layout assembly of
``detect()``: the program's ``union_rows`` over its ``union_calls``
(``xmhw_tpu_torch.utils.counts``), from the process's start, whose
set-up runs the window's calls. A program without the ``union_rows``
counter reads None."""

from benchmark.lib.counts import program


def read(run):
    c = program()
    if not c or "union_rows" not in c or not c.get("union_calls"):
        return None
    return c["union_rows"] / c["union_calls"]
