"""Reference-style import path: ``from xmhw_tpu_torch.features import
flip_cold`` mirrors the reference's ``xmhw.features``
(reference: xmhw/features.py). The per-event feature computations
themselves live in the device kernels (core/features_scan.py); the
closed-form helpers are exposed here for direct use."""

from __future__ import annotations

import numpy as np

from .api import flip_cold  # noqa: F401

__all__ = ["flip_cold", "get_edge", "get_period", "get_rate"]


def get_rate(relSeas_peak, relSeas_edge, period):
    """Onset/decline rate (reference: features.py:196-198)."""
    return (np.asarray(relSeas_peak) - np.asarray(relSeas_edge)) / \
        np.asarray(period)


def get_edge(relS, anom, idx, edge):
    """Relative start/end of an MHW (reference: features.py:201-222)."""
    relS = np.asarray(relS, float)
    anom = np.asarray(anom, float)
    idx = np.asarray(idx)
    x = np.where(idx == edge, relS, anom)
    return 0.5 * (relS + x)


def get_period(start, end, peak, tsend):
    """Onset/decline periods with the reference's boundary rules
    (reference: features.py:225-263, literal semantics incl. the
    ``peak != tsend`` comparison)."""
    start = np.asarray(start, float)
    end = np.asarray(end, float)
    peak = np.asarray(peak, float)
    esp = end - start - peak
    x = np.where(peak != 0, peak, 1.0)
    onset_period = np.where(start == 0, x, x + 0.5)
    y = np.where(peak != tsend, esp, 1.0)
    decline_period = np.where(end == tsend, y, y + 0.5)
    return onset_period, decline_period
