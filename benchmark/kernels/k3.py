"""Kernel 3, the event statistics: each event's sums, moments, maxima and
edge values, written into its (K, C) slot
(``xmhw_tpu_torch/ops/detect_scan.py``, ``csrc/detect_scan.cu``).

The work of the stage from the contract in ``ops/detect_scan.py``: read
once, the (T, C) float32 series, the (ndoy, C) float32 thresholds and
means, the (T,) int32 row of each step, and the (T, C) bool
``event_day`` and ``is_start``; written once, F (30, K, C) float32 and
I (3, K, C) int32. Operations: about 40 a day of each cell (four
quantities' moments, categories and maxima); counted for every day, an
upper bound that stays below the bytes' bound.
"""

TRACE_NAMES = ("event_scan_kernel",)
F_CHANNELS, I_CHANNELS = 30, 3


def work(ts, th, se, doy_pos, day, is_start, K):
    T, C = ts.shape
    ndoy = th.shape[0]
    read = 4 * T * C + 2 * 4 * ndoy * C + 4 * T + 2 * T * C
    return read + (F_CHANNELS + I_CHANNELS) * 4 * K * C, 40 * T * C


CALLS = {("xmhw_tpu_torch.ops.detect_scan", "event_stats"): work}
