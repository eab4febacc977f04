"""The control: the reference put in the program's place, in bfloat16.

The configurations state float32. The nearest precision below it, the
step a later change might be tempted to take, is bfloat16 (no matrix
product runs here, so TF32 does not apply). The control stores what a
bfloat16 program would store: the series rounded to bfloat16, the
thresholds and means worked out from it and rounded, the events of the
rounded series against the rounded thresholds, and every property and
statistic rounded. The judge must find it not correct.
"""

from __future__ import annotations

import numpy as np

from . import calendar, stats
from .clim import clim_many
from .judge import Case
from .oracle import events_oracle


def bf16(x):
    """Round to the nearest bfloat16 (ties to even), kept as float64."""
    x32 = np.asarray(x, np.float32)
    bits = x32.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32).astype(np.float64)
    return np.where(np.isnan(x32), np.nan, out)


def cases(ts, setup, with_stats=False, where="control"):
    """Cases for the columns of ``ts`` (T, m) as the bfloat16 control
    answers them."""
    doy, ndoy = calendar.rows(setup.dates, setup.tstep)
    pos = doy - 1
    xb = bf16(ts)
    th, se = clim_many(xb, doy, ndoy, setup.w, setup.pctile, setup.smooth,
                       setup.smooth_w, feb29=not setup.tstep)
    th, se = bf16(th), bf16(se)
    year = calendar.years(setup.dates)
    out = []
    for j in range(xb.shape[1]):
        evs = events_oracle(xb[:, j], th[pos, j], se[pos, j],
                            setup.min_duration, setup.join_gaps,
                            setup.max_gap)
        keys = evs[0].keys() if evs else ("index_start", "index_end")
        events = {k: bf16([e[k] for e in evs]) if evs else np.zeros(0)
                  for k in keys}
        for k in ("event", "index_start", "index_end", "index_peak",
                  "duration"):
            if evs:
                events[k] = np.asarray([e[k] for e in evs])
        block = day = None
        if with_stats:
            block = {k: bf16(v) for k, v in
                     stats.event_stats(evs, year, setup.bins).items()}
            cats = stats.categories(xb[:, j], th[pos, j], se[pos, j])
            day = {k: bf16(v) for k, v in stats.day_stats(
                xb[:, j], cats, stats.day_edges(year, setup.bins)).items()}
        out.append(Case(ts=np.asarray(ts[:, j]), th=th[:, j], se=se[:, j],
                        events=events, n_raw=len(evs), block=block, day=day,
                        where=f"{where} cell {j}"))
    return out
