"""Kernel 1, the climatology stage: each (row, cell) pool's percentile and
mean (``xmhw_tpu_torch/ops/doy_quantile.py``, ``csrc/doy_quantile.cu``).

The work of the stage, whatever implements it, from the shapes of one
call: the (T, C) float32 series read once (the ``rmax`` NaN rows that
pad it are the kernel's layout, not the stage's input), the (ndoy, C)
float32 thresholds and means written once. Operations: every pooled
value is added to its pool's mean and compared in its pool's selection,
and each of the T steps joins ``rmax`` = 2w + 1 pools.
"""

TRACE_NAMES = ("doy_quantile_kernel", "doy_quantile_long_kernel")


def work(ts_padded, starts, lens, ndoy, ny, rmax, pctile=90):
    """(bytes, operations) of one call of the stage."""
    T = ts_padded.shape[0] - rmax
    C = ts_padded.shape[1]
    return 4 * T * C + 2 * 4 * ndoy * C, 2 * rmax * T * C


# where the program calls the stage: (module, attribute) -> work count
CALLS = {("xmhw_tpu_torch.core.pipeline", "doy_quantile"): work}
