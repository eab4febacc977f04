"""Reference-style import path: ``from xmhw_tpu_torch.stats import
block_average, mhw_rank`` mirrors the reference's ``xmhw.stats``
(reference: xmhw/stats.py)."""

import numpy as np

from .stats_api import (  # noqa: F401
    block_average,
    check_variables,
    find_across,
    mhw_rank,
    rank_variable,
)

__all__ = ["block_average", "cat_days", "check_variables", "find_across",
           "mhw_rank", "rank_variable"]


def cat_days(series, cat=1):
    """Count of entries equal to ``cat`` (reference: stats.py:366-368)."""
    s = np.asarray(series)
    return int((s == cat).sum())
