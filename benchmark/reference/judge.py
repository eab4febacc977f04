"""The comparison that decides ``correct``: a program's answers for sampled
cells against the plain reference, worked out again from the same inputs.

The reference computes in float64 (:mod:`.clim`, :mod:`.oracle`,
:mod:`.stats`). A program that computes in float32 lands within rounding
of it, and rounding can move a decision that compares two numbers: a day
whose value lies within that rounding of the threshold, the peak among
two near-equal days, a category at its boundary. The judge accepts
either side of such a decision, and only there:

* a day is exceedance or not as the program's own threshold says where
  the program's and the reference's thresholds lie on either side of the
  day's value and the day lies within ``limit`` (the climatology's limit)
  of the reference's threshold; elsewhere as the reference's says;
* an event's peak is the program's where the reference's anomaly on that
  day is within ``2 * limit`` of the event's largest, and the reference
  then takes that day as the peak;
* a count of category days, and an event's category, lies between the
  least and the most that thresholds and means within ``limit`` of the
  reference's give.

Readings (the worst over the sampled cells):

* ``clim_gap``: the largest |program - reference| of thresh and seas;
* ``event_cells_off``: cells whose events (their count, raw count, start
  and end days) differ from the reference's;
* ``event_fields_off``: values of the program's events that differ where
  they have to be equal (days, dates, durations) or lie outside their
  interval (peak, category, category days), over every program event
  whose start and end days are a reference event's, in any cell;
* ``event_gap``: the largest |program - reference| / (1 + |reference|)
  of the other properties of those events;
* with year-bin statistics, in every cell: ``block_gap`` and ``day_gap``,
  the same gap of the event and the day statistics (the event statistics
  of the reference's events), and ``day_counts_off``, category day
  counts outside their interval.

A NaN where the reference has a number, or the reverse, is a gap of inf.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import calendar, stats
from .clim import clim_many
from .oracle import events_oracle

EXACT = ("event", "index_start", "index_end", "duration")
CATEGORY = {"duration_moderate": (1, 1), "duration_strong": (2, 2),
            "duration_severe": (3, 3), "duration_extreme": (4, np.inf)}
DAY_COUNTS = {**{k: (v, v) for k, v in stats.CATEGORY_DAYS.items()},
              "total_days": (1, 4)}
TIMES = {"time_start": "index_start", "time_end": "index_end",
         "time_peak": "index_peak"}
FLOATS = (
    "intensity_max", "intensity_mean", "intensity_cumulative",
    "intensity_var", "severity_max", "severity_mean",
    "severity_cumulative", "severity_var", "intensity_mean_relThresh",
    "intensity_cumulative_relThresh", "intensity_var_relThresh",
    "intensity_max_relThresh", "intensity_mean_abs",
    "intensity_cumulative_abs", "intensity_var_abs", "intensity_max_abs",
    "rate_onset", "rate_decline",
)


@dataclass
class Setup:
    """What the configuration states, and the time axis."""
    dates: np.ndarray
    tstep: bool = False
    w: int = 5
    pctile: float = 90
    smooth: bool = True
    smooth_w: int = 31
    min_duration: int = 5
    join_gaps: bool = True
    max_gap: int = 2
    bins: np.ndarray | None = None  # year-bin edges, with statistics

    @classmethod
    def of(cls, cfg, dates, bins=None):
        """From a configuration file's ``definition``; ``bins``: the first
        and last year of one-year statistics bins, where the run has
        them."""
        d = cfg["definition"]
        return cls(dates=np.asarray(dates), tstep=bool(d.get("tstep")),
                   w=d["windowHalfWidth"], pctile=d["pctile"],
                   smooth=d["smoothPercentile"],
                   smooth_w=d["smoothPercentileWidth"],
                   min_duration=d["minDuration"], join_gaps=d["joinGaps"],
                   max_gap=d["maxGap"],
                   bins=None if bins is None else np.arange(
                       bins[0], bins[1] + 2))


@dataclass
class Case:
    """One sampled cell as the program answered it. ``events``: property
    -> (n,) values of its n events in time order; ``n_raw``: the raw
    count where the program reports one; ``rows``: the event coordinate
    of each event, where the layout has one; ``block``/``day``: name ->
    (nbins,) year-bin statistics."""
    ts: np.ndarray
    th: np.ndarray
    se: np.ndarray
    events: dict
    n_raw: int | None = None
    rows: np.ndarray | None = None
    block: dict | None = None
    day: dict | None = None
    where: str = ""


@dataclass
class Readings:
    values: dict = field(default_factory=dict)
    worst: dict = field(default_factory=dict)  # reading -> the cell

    def put(self, name, value, where, how=max):
        old = self.values.get(name)
        value = float(value) if isinstance(value, float) else int(value)
        new = value if old is None else how(old, value)
        if np.isnan(new):
            new = np.inf
        if old is None or new != old:
            self.worst[name] = where
        self.values[name] = new


def _add(a, b):
    return a + b


def gap(p, r, relative=False):
    """Largest |p - r| (over 1 + |r| when ``relative``); inf where exactly
    one of the two is NaN."""
    p = np.asarray(p, np.float64)
    r = np.asarray(r, np.float64)
    if p.shape != r.shape:
        return np.inf
    if (np.isnan(p) != np.isnan(r)).any():
        return np.inf
    ok = ~np.isnan(r)
    if not ok.any():
        return 0.0
    d = np.abs(p[ok] - r[ok])
    if relative:
        d = d / (1.0 + np.abs(r[ok]))
    return float(d.max())


def cat_bounds(ts, th_t, se_t, limit):
    """Least and largest category of each day over thresholds and means
    within ``limit`` of the reference's."""
    c = [stats.categories(ts, th_t + a, se_t + b)
         for a in (-limit, limit) for b in (-limit, limit)]
    return np.min(c, axis=0), np.max(c, axis=0)


def judge(cases, setup, limit):
    """Readings of ``cases`` (one time axis) against the reference."""
    out = Readings()
    if not cases:
        raise ValueError("nothing to judge: no sampled cell")
    doy, ndoy = calendar.rows(setup.dates, setup.tstep)
    pos = doy - 1
    x = np.stack([np.asarray(c.ts, np.float64) for c in cases], axis=1)
    th_r, se_r = clim_many(x, doy, ndoy, setup.w, setup.pctile, setup.smooth,
                           setup.smooth_w, feb29=not setup.tstep)
    year = calendar.years(setup.dates)
    for j, c in enumerate(cases):
        _judge_cell(out, c, x[:, j], th_r[:, j], se_r[:, j], pos, year,
                    setup, limit)
    return out


def _judge_cell(out, c, ts, th_r, se_r, pos, year, setup, limit):
    where = c.where
    th_p = np.asarray(c.th, np.float64)
    se_p = np.asarray(c.se, np.float64)
    out.put("clim_gap", max(gap(th_p, th_r), gap(se_p, se_r)), where)
    tht_r, set_r = th_r[pos], se_r[pos]
    fin = np.isfinite(ts)
    b_r = fin & np.isfinite(tht_r) & (ts > tht_r)
    if th_p.shape == th_r.shape:
        tht_p = th_p[pos]
        b_p = fin & np.isfinite(tht_p) & (ts > tht_p)
        b = np.where((b_r != b_p) & (np.abs(ts - tht_r) <= limit), b_p, b_r)
    else:
        b = b_r
    kw = dict(min_duration=setup.min_duration, join_gaps=setup.join_gaps,
              max_gap=setup.max_gap, b=b)
    ref = events_oracle(ts, tht_r, set_r, **kw)
    ev = {k: np.asarray(v) for k, v in c.events.items()}
    n = len(ev["index_start"])
    same = (n == len(ref) and (c.n_raw is None or int(c.n_raw) == len(ref))
            and np.array_equal(np.asarray(ev["index_start"], np.float64),
                               [e["index_start"] for e in ref])
            and np.array_equal(np.asarray(ev["index_end"], np.float64),
                               [e["index_end"] for e in ref])
            and (c.rows is None or np.array_equal(
                np.asarray(c.rows, np.float64),
                [e["index_start"] for e in ref])))
    out.put("event_cells_off", 0 if same else 1, where, how=_add)
    # every program event whose start and end days are a reference
    # event's is judged field by field, in any cell
    at = {(int(e["index_start"]), int(e["index_end"])): e for e in ref}
    match = []
    for k in range(n):
        a, z = float(ev["index_start"][k]), float(ev["index_end"][k])
        if np.isfinite(a) and np.isfinite(z) and (int(a), int(z)) in at:
            match.append((k, int(a), int(z)))
    # peaks: the program's, where the reference finds it a near-maximum
    peaks = {}
    for k, s, t1 in match:
        p = float(ev["index_peak"][k])
        rel = ts[s:t1 + 1] - set_r[s:t1 + 1]
        if (np.isfinite(p) and s <= p <= t1 and p == int(p)
                and rel[int(p) - s] >= np.nanmax(rel) - 2 * limit):
            peaks[s] = int(p)
    ref = events_oracle(ts, tht_r, set_r, peaks=peaks, **kw)
    at = {(int(e["index_start"]), int(e["index_end"])): e for e in ref}
    lo, hi = cat_bounds(ts, tht_r, set_r, limit)
    off = 0
    worst = 0.0
    for k, s, t1 in match:
        e = at[(s, t1)]
        for name in EXACT + ("index_peak",):
            off += float(ev[name][k]) != float(e[name])
        for name, idx in TIMES.items():
            if name not in ev:
                continue
            got, t = np.asarray(ev[name])[k], int(e[idx])
            if np.issubdtype(got.dtype, np.datetime64):
                off += bool(got.astype("datetime64[ns]")
                            != setup.dates[t].astype("datetime64[ns]"))
            else:
                off += float(got) != t
        clo, chi = lo[s:t1 + 1], hi[s:t1 + 1]
        for name, (a, z) in CATEGORY.items():
            least = int(((clo >= a) & (chi <= z)).sum())
            most = int(((chi >= a) & (clo <= z)).sum())
            v = float(ev[name][k])
            off += not (least <= v <= most)
        v = float(ev["category"][k])
        off += not (min(np.nanmax(clo), 4.0) <= v <= min(np.nanmax(chi), 4.0))
        for name in FLOATS:
            worst = max(worst, gap(ev[name][k], e[name], relative=True))
    out.put("event_fields_off", off, where, how=_add)
    out.put("event_gap", worst, where)
    if c.block is not None:
        want = stats.event_stats(ref, year, setup.bins)
        out.put("block_gap", max(gap(c.block[k], v, relative=True)
                                 for k, v in want.items()), where)
    if c.day is not None:
        edges = stats.day_edges(year, setup.bins)
        want = stats.day_stats(ts, stats.categories(ts, tht_r, set_r), edges)
        out.put("day_gap", max(gap(c.day[k], want[k], relative=True)
                               for k in ("ts_mean", "ts_max", "ts_min")),
                where)
        bad = 0
        for b in range(len(edges) - 1):
            clo, chi = lo[edges[b]:edges[b + 1]], hi[edges[b]:edges[b + 1]]
            for name, (a, z) in DAY_COUNTS.items():
                least = int(((clo >= a) & (chi <= z)).sum())
                most = int(((chi >= a) & (clo <= z)).sum())
                bad += not (least <= float(c.day[name][b]) <= most)
        out.put("day_counts_off", bad, where, how=_add)


def verdict(readings, limits):
    """(correct, [(name, reading, limit)]): every reading at or under its
    limit; a reading without a limit, or a limit without a reading, fails."""
    rows = []
    ok = True
    for name in sorted(set(readings) | set(limits)):
        r, lim = readings.get(name), limits.get(name)
        good = r is not None and lim is not None and r <= lim
        ok &= good
        rows.append((name, r, lim))
    return ok, rows


def table_cases(ts, th, se, table, n_raw, cols, where, block=None, day=None):
    """Cases of the columns ``cols`` of a program's host outputs: ``ts``
    (T, C) inputs, ``th``/``se`` (ndoy, C), ``table`` property -> (K, C)
    event table (its first min(n, K) rows the events of a cell), ``n_raw``
    (C,) raw counts, ``block``/``day`` name -> (nbins, C)."""
    out = []
    for j in cols:
        n = int(n_raw[j])
        k = min(n, next(iter(table.values())).shape[0])
        out.append(Case(
            ts=np.asarray(ts[:, j]), th=np.asarray(th[:, j]),
            se=np.asarray(se[:, j]),
            events={name: np.asarray(v[:k, j]) for name, v in table.items()},
            n_raw=n,
            block=None if block is None else {n_: np.asarray(v[:, j])
                                              for n_, v in block.items()},
            day=None if day is None else {n_: np.asarray(v[:, j])
                                          for n_, v in day.items()},
            where=f"{where} cell {j}"))
    return out
