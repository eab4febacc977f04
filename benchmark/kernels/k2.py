"""Kernel 2, event identification: runs of the exceedance mask, the
minimum duration and the joining of short gaps
(``xmhw_tpu_torch/ops/rle.py``, ``csrc/rle.cu``).

The work of the stage from the contract in ``ops/rle.py``: the (T, C)
bool mask read once; written once, each output the call asks for:
``event_day`` and ``is_start`` (T, C) bool, ``n_events`` (C,) int32,
``slot`` (T, C) int32 where asked, and ``event_id``, ``ev_start`` and
``ev_end`` (T, C) int32 for the full output; the counting call writes
``n_events`` alone. Operations: a few integer steps a day, far below
the bytes' bound; counted as 4 a day of each cell.
"""

TRACE_NAMES = ("rle_kernel",)


def _filter(bthresh, min_duration=5, join_gaps=True, max_gap=2,
            day0_fillna_quirk=False, full=True, slot=True):
    T, C = bthresh.shape
    out = 2 * T * C + 4 * C + 4 * T * C * bool(slot) + 12 * T * C * bool(full)
    return T * C + out, 4 * T * C


def _counts(bthresh, min_duration=5, join_gaps=True, max_gap=2,
            day0_fillna_quirk=False):
    T, C = bthresh.shape
    return T * C + 4 * C, 4 * T * C


CALLS = {("xmhw_tpu_torch.ops.rle", "mhw_filter"): _filter,
         ("xmhw_tpu_torch.ops.rle", "event_counts"): _counts}
