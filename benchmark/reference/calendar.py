"""Day-of-year rows and years of a time axis, in plain NumPy.

The reference works these out from the dates alone (Hobday et al. 2016;
the xmhw convention): daily data on a 366-row calendar in which 1 March
is always row 61, so a common year skips row 60 (29 February); data
climatologised by its own time step (``tstep``) numbers the steps of
each year 1..N and needs whole years.
"""

from __future__ import annotations

import numpy as np


def years(dates):
    """Calendar year of each datetime64 value."""
    return np.asarray(dates).astype("datetime64[Y]").astype(np.int64) + 1970


def doy366(dates):
    """1-based day-of-year rows on the 366-row calendar."""
    d = np.asarray(dates).astype("datetime64[D]")
    y = years(d)
    first = d.astype("datetime64[Y]").astype("datetime64[D]")
    day = (d - first).astype(np.int64) + 1
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    month = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    return day + ((~leap) & (month >= 3))


def doy_tstep(dates):
    """1-based step of each value within its year; raises unless the
    series holds whole years of equal length."""
    y = years(dates)
    per = np.bincount(y - y[0])
    if len(per) < 2 or (per != per[0]).any():
        raise ValueError("tstep rows need whole years of equal length")
    return np.tile(np.arange(1, per[0] + 1), len(per))


def rows(dates, tstep):
    """(doy rows (T,), number of rows): the climatology row of each step."""
    if tstep:
        d = doy_tstep(dates)
        return d, int(d.max())
    return doy366(dates), 366
