"""The documented notebook pass for one cell, in plain PyTorch float64 on
the CPU, and its comparison with a program's answers.

The workflow (``docs/gettingstarted.md`` "Workflow", steps 1-4; upstream
xmhw's ``docs/gettingstarted.rst``)::

    clim = threshold(sst)
    mhw, inter = detect(sst, clim["thresh"], clim["seas"],
                        intermediate=True)
    blk = block_average(mhw, dstime=inter)
    rank, return_period = mhw_rank(mhw)

:mod:`.clim` and :mod:`.oracle` reckon the first two steps; this module
reckons the rest from a cell's series, its climatology on each day and
the oracle's events:

* :func:`intermediate`: the 15 per-day series of upstream xmhw's
  intermediate output (its ``identify.py`` and ``xmhw.py:471-478``, as
  ``docs/workflows.md`` lists them). Every one but ``ts`` and
  ``bthresh`` is NaN (False for the flags) off the days of an event; a
  gap that ``joinGaps`` closes belongs to its event;
* :func:`day_stats`: ``block_average``'s day statistics with
  ``dstime=inter``, :func:`.stats.day_stats` of the intermediate series:
  the category days are counted over the days of events alone, since
  the intermediate ``cats`` is NaN elsewhere; the event statistics are
  :func:`.stats.event_stats`;
* :func:`ranks` and :func:`return_periods`: ``mhw_rank``'s.

Departures from upstream, each also the port's (``stats_api.py``'s
docstring):

* the events of a cell are ranked among themselves, 1 the largest; an
  event whose value is NaN has rank NaN; among equal values the earlier
  event has the larger rank (upstream's double argsort, stats.py:493-510);
* ``nYears`` is the record the events span, from the first start to the
  last end over every cell, in days over 365.25, where upstream fixes
  14245 / 365.25 (stats.py:477-478).

:func:`check` holds a program's answers for a block of cells against
this reference, a decision that float32 can move judged on either side,
as :mod:`.judge` does; :data:`LIMITS` gives each reading's limit and
why.
"""

from __future__ import annotations

import numpy as np
import torch

from . import calendar, stats
from .clim import clim_many
from .judge import CATEGORY, EXACT, cat_bounds, gap
from .oracle import events_oracle

F64 = torch.float64
INTER_VARS = ("ts", "seas", "thresh", "bthresh", "events", "relSeas",
              "relThresh", "relThreshNorm", "severity", "cats",
              "duration_moderate", "duration_strong", "duration_severe",
              "duration_extreme", "mabs")
FLAGS = {"duration_moderate": (1, 1), "duration_strong": (2, 2),
         "duration_severe": (3, 3), "duration_extreme": (4, np.inf)}
# block_average's day statistics
DAY_STATS = ("ts_mean", "ts_max", "ts_min", *stats.CATEGORY_DAYS,
             "total_days")
# mhw_rank ranks every event variable whose name holds none of these
NOT_RANKED = ("event", "time", "index")
# intermediate series held to the climatology's limit (absolute, degC)
# and to the events' (relative)
CLIM_SERIES = ("seas", "thresh")
VALUE_SERIES = ("ts", "relSeas", "relThresh", "relThreshNorm", "severity",
                "mabs")

# readings of :func:`check` -> limit. The climatology's and the events'
# limits are the cell's own (limits/<cell>.json: clim_gap, event_gap),
# passed in; these are the others:
LIMITS = {
    # every decision of a day (exceedance, event label, category, flags,
    # where a series is NaN) as the reference makes it, or on the side
    # the program's own threshold takes within the climatology's limit
    "inter_days_off": 0,
    # the day statistics are float64 sums of the float32 series: the
    # relative rounding of a year's mean is ~1e-7; oisst_stats' limit
    "day_gap": 1e-4,
    # category days inside the least and most that thresholds and means
    # within the climatology's limit give, as the judge counts them
    "day_counts_off": 0,
    # ranks of the program's own values exact; against the reference's
    # values exact but between events whose values the judge accepts on
    # either side of each other (within the events' limit, categories
    # and category days within their bounds, the accepted peak day's)
    "rank_off": 0,
    # return period times rank is nYears + 1: the same float64 division
    # on both sides, to a few units of its last place
    "return_period_gap": 1e-12,
}


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def intermediate(ts, th_t, se_t, events):
    """The intermediate series of a cell: ``ts``, ``th_t``, ``se_t`` (T,)
    the series and its threshold and mean on each day; ``events`` the
    oracle's events (each day of [index_start, index_end] an event day,
    labelled by index_start). Returns name -> (T,) tensor, float64, the
    flags bool."""
    ts, th, se = _t(ts), _t(th_t), _t(se_t)
    T = ts.shape[0]
    nan = torch.tensor(float("nan"), dtype=F64)
    label = torch.full((T,), float("nan"), dtype=F64)
    for e in events:
        s, z = int(e["index_start"]), int(e["index_end"])
        label[s:z + 1] = float(s)
    day = ~torch.isnan(label)
    rel_s = torch.where(day, ts - se, nan)
    rel_t = torch.where(day, ts - th, nan)
    th_se = th - se
    norm = torch.where(day, rel_t / th_se, nan)
    cats = torch.floor(1.0 + norm)
    out = {"ts": ts, "seas": torch.where(day, se, nan),
           "thresh": torch.where(day, th, nan),
           # NaN compares False, as ``ts > thresh`` does upstream
           "bthresh": ts > th, "events": label, "relSeas": rel_s,
           "relThresh": rel_t, "relThreshNorm": norm,
           "severity": torch.where(day, rel_s / -th_se, nan),
           "cats": cats, "mabs": torch.where(day, ts, nan)}
    for name, (a, z) in FLAGS.items():
        out[name] = (cats >= a) & (cats <= z) & day
    return {k: out[k] for k in INTER_VARS}


def day_stats(inter, edges):
    """``block_average``'s day statistics of a cell's intermediate series
    (bins starting at the time indexes ``edges``): name -> (nbins,)
    float64."""
    return stats.day_stats(inter["ts"].numpy(), inter["cats"].numpy(),
                           edges)


def ranks(values):
    """(n,) values of a cell's events -> (n,) float64 ranks: 1 + the
    events with a larger value + the later events with an equal one; NaN
    where the value is NaN."""
    v = _t(values)
    fin = torch.isfinite(v)
    n = v.shape[0]
    larger = (v[None, :] > v[:, None]) & fin[None, :]
    later = torch.arange(n)[None, :] > torch.arange(n)[:, None]
    equal = (v[None, :] == v[:, None]) & later
    r = 1.0 + larger.sum(1).to(F64) + equal.sum(1).to(F64)
    return torch.where(fin, r, torch.tensor(float("nan"), dtype=F64))


def accepted(name, events, lo, hi, tol):
    """(least, largest) value of ``name`` of each reference event that
    the judge accepts of a program: the category days and the category
    inside the bounds of the event's days' categories (``lo``/``hi``, as
    :func:`.judge.cat_bounds` gives them), the duration exact, any other
    value within ``tol`` relative."""
    out = []
    for e in events:
        s, z = int(e["index_start"]), int(e["index_end"])
        clo, chi = lo[s:z + 1], hi[s:z + 1]
        if name in CATEGORY:
            a, b = CATEGORY[name]
            out.append((((clo >= a) & (chi <= b)).sum(),
                        ((chi >= a) & (clo <= b)).sum()))
        elif name == "category":
            out.append((min(np.nanmax(clo), 4.0), min(np.nanmax(chi), 4.0)))
        elif name in EXACT:
            out.append((e[name], e[name]))
        else:
            r = e[name]
            out.append((r - tol * (1 + abs(r)), r + tol * (1 + abs(r))))
    return (np.asarray([a for a, _ in out], np.float64).reshape(-1),
            np.asarray([b for _, b in out], np.float64).reshape(-1))


def rank_band(least, most):
    """(least, most) rank of each event whose value may lie anywhere in
    [least, most] (NaN: no value, no rank): 1 + the events surely larger,
    and the ranked events less those surely smaller."""
    lo, hi = _t(least), _t(most)
    fin = torch.isfinite(lo) & torch.isfinite(hi)
    above = (lo[None, :] > hi[:, None]) & fin[None, :]
    below = (hi[None, :] < lo[:, None]) & fin[None, :]
    return 1 + above.sum(1), fin.sum() - below.sum(1)


def event_span(events_by_cell):
    """(first start, last end) of the events of every cell, or None."""
    span = [(int(e["index_start"]), int(e["index_end"]))
            for ev in events_by_cell for e in ev]
    if not span:
        return None
    return min(a for a, _ in span), max(b for _, b in span)


def n_years(dates, span):
    """``mhw_rank``'s nYears of the events' ``span`` (:func:`event_span`;
    None: no events, no nYears): days over 365.25."""
    if span is None:
        return None
    d = np.asarray(dates).astype("datetime64[ns]")
    return float((d[span[1]] - d[span[0]]) / np.timedelta64(1, "D")
                 / 365.25)


def return_periods(rank, nyears):
    return (nyears + 1.0) / _t(rank)


def rank_names(events):
    """The event variables ``mhw_rank`` ranks, of a program's ``events``
    (property -> values)."""
    return sorted(k for k in events if not any(x in k for x in NOT_RANKED))


def settled_exceedance(ts, tht_r, tht_p, limit):
    """The judge's exceedance of a cell: the reference threshold's, but
    the program's own where they fall on either side of a day that lies
    within ``limit`` of the reference's threshold."""
    fin = np.isfinite(ts)
    b_r = fin & np.isfinite(tht_r) & (ts > tht_r)
    b_p = fin & np.isfinite(tht_p) & (ts > tht_p)
    return np.where((b_r != b_p) & (np.abs(ts - tht_r) <= limit), b_p, b_r)


def check(cells, setup, limit, event_limit):
    """Readings of a block of cells against the reference.

    ``cells``: dicts with ``ts`` (T,), ``th``/``se`` (ndoy,) the
    program's climatology, ``events`` (property -> (n,) the program's
    events in time order), ``inter`` (name -> (T,)), ``day`` (name ->
    (nbins,), ``block_average``'s day statistics), ``rank`` and ``rp``
    (variable -> (n,)) and ``where``. ``limit``/``event_limit``: the
    cell's ``clim_gap`` and ``event_gap``.

    Returns (readings, worst: reading -> the cell, the reference's events
    of each cell, (least, largest) return period times rank over the
    block's ranked events). The readings: ``inter_clim_gap`` (largest
    absolute gap of ``seas``/``thresh``), ``inter_gap`` (largest relative
    gap of the other value series), ``inter_days_off``, ``day_gap``,
    ``day_counts_off`` and ``rank_off``; ranks are judged in cells whose
    events are the reference's (the judge counts the others). nYears
    spans every cell, so :func:`return_period_gap` takes the products of
    every block."""
    doy, ndoy = calendar.rows(setup.dates, setup.tstep)
    pos = doy - 1
    x = np.stack([np.asarray(c["ts"], np.float64) for c in cells], axis=1)
    th_r, se_r = clim_many(x, doy, ndoy, setup.w, setup.pctile,
                           setup.smooth, setup.smooth_w,
                           feb29=not setup.tstep)
    year = calendar.years(setup.dates)
    edges = stats.day_edges(year, setup.bins)
    vals = {k: 0 for k in ("inter_days_off", "day_counts_off", "rank_off")}
    vals.update(inter_clim_gap=0.0, inter_gap=0.0, day_gap=0.0)
    worst = {}
    k_lo, k_hi = np.inf, -np.inf
    ref_events = []

    def put(name, v, where, add=False):
        old = vals[name]
        new = old + v if add else max(old, v)
        if new != old:
            worst[name] = where
        vals[name] = new

    for j, c in enumerate(cells):
        where = c.get("where", f"cell {j}")
        ts = x[:, j]
        tht_r, set_r = th_r[pos, j], se_r[pos, j]
        tht_p = np.asarray(c["th"], np.float64)[pos]
        b = settled_exceedance(ts, tht_r, tht_p, limit)
        ev = events_oracle(ts, tht_r, set_r, setup.min_duration,
                           setup.join_gaps, setup.max_gap, b=b)
        ref_events.append(ev)
        want = intermediate(ts, tht_r, set_r, ev)
        got = {k: np.asarray(c["inter"][k]) for k in INTER_VARS}
        put("inter_clim_gap", max(gap(got[k], want[k].numpy())
                                  for k in CLIM_SERIES), where)
        put("inter_gap", max(gap(got[k], want[k].numpy(), relative=True)
                             for k in VALUE_SERIES), where)
        lo, hi = cat_bounds(ts, tht_r, set_r, limit)
        put("inter_days_off", _days_off(got, want, b, lo, hi), where,
            add=True)
        day = want["events"].isfinite().numpy()
        # the program's day statistics against the reference's, the
        # category days inside the bounds of the event days' categories
        d_want = day_stats(want, edges)
        put("day_gap", max(gap(c["day"][k], d_want[k], relative=True)
                           for k in ("ts_mean", "ts_max", "ts_min")), where)
        lo_d = np.where(day, lo, np.nan)
        hi_d = np.where(day, hi, np.nan)
        put("day_counts_off", _counts_off(c["day"], lo_d, hi_d, edges),
            where, add=True)
        starts = np.asarray(c["events"]["index_start"], np.float64)
        if not np.array_equal(starts, [e["index_start"] for e in ev]):
            continue
        # the peaks the judge accepts of the program, for the values
        # taken on the peak day
        peaks = {}
        for e, pk in zip(ev, c["events"]["index_peak"]):
            s, z = int(e["index_start"]), int(e["index_end"])
            rel = ts[s:z + 1] - set_r[s:z + 1]
            if (np.isfinite(pk) and s <= pk <= z and pk == int(pk)
                    and rel[int(pk) - s] >= np.nanmax(rel) - 2 * limit):
                peaks[s] = int(pk)
        ev = events_oracle(ts, tht_r, set_r, setup.min_duration,
                           setup.join_gaps, setup.max_gap, b=b, peaks=peaks)
        off = 0
        for name in rank_names(c["events"]):
            p = np.asarray(c["events"][name], np.float64)
            r = np.asarray(c["rank"][name], np.float64)
            own = ranks(p).numpy()
            least, most = (t.numpy() for t in rank_band(
                *accepted(name, ev, lo, hi, event_limit)))
            fin = np.isfinite(own)
            bad = int((~((r == own) | (np.isnan(r) & ~fin))).sum()
                      + (fin & ((r < least) | (r > most))).sum())
            if bad:
                off += bad
                where = f"{where} {name}"
            kk = np.asarray(c["rp"][name], np.float64)[fin] * r[fin]
            if kk.size:
                k_lo, k_hi = min(k_lo, kk.min()), max(k_hi, kk.max())
        put("rank_off", off, where, add=True)
    return vals, worst, ref_events, (float(k_lo), float(k_hi))


def return_period_gap(products, nyears):
    """The reading ``return_period_gap``: the largest |return period x
    rank - (nyears + 1)| / (nyears + 1) over ``products``, the (least,
    largest) of each block; inf where no event was ranked."""
    lo = min(p[0] for p in products)
    hi = max(p[1] for p in products)
    if nyears is None or not np.isfinite(lo):
        return float("inf")
    return float(max(abs(lo - (nyears + 1)), abs(hi - (nyears + 1)))
                 / (nyears + 1))


def _days_off(got, want, b, lo, hi):
    """Days whose decisions the program makes otherwise than the
    reference, on neither side of a decision float32 can move: the
    exceedance (``b``: the judge's), the event label, where a series is
    NaN, the category (inside [lo, hi]) and the flags (the program's own
    category's)."""
    off = int((np.asarray(got["bthresh"], bool) != b).sum())
    ev_w = want["events"].numpy()
    ev_g = np.asarray(got["events"], np.float64)
    off += int((~((ev_g == ev_w) | (np.isnan(ev_g) & np.isnan(ev_w))))
               .sum())
    day = np.isfinite(ev_w)
    for k in INTER_VARS:
        if k in FLAGS or k == "bthresh":
            continue
        g = np.asarray(got[k], np.float64)
        w = want[k].numpy()
        off += int((np.isnan(g) != np.isnan(w)).sum())
    cats = np.asarray(got["cats"], np.float64)
    inside = (cats >= lo) & (cats <= hi)
    off += int((day & np.isfinite(cats) & ~inside).sum())
    for name, (a, z) in FLAGS.items():
        own = day & (cats >= a) & (cats <= z)
        off += int((np.asarray(got[name], bool) != own).sum())
    return off


def _counts_off(day, lo, hi, edges):
    """Category day counts of the bins outside the least and most the
    bounds ``lo``/``hi`` (NaN off event days) give."""
    bad = 0
    for b in range(len(edges) - 1):
        clo, chi = lo[edges[b]:edges[b + 1]], hi[edges[b]:edges[b + 1]]
        for name, (a, z) in {**{k: (v, v) for k, v in
                                stats.CATEGORY_DAYS.items()},
                             "total_days": (1, 4)}.items():
            least = int(((clo >= a) & (chi <= z)).sum())
            most = int(((chi >= a) & (clo <= z)).sum())
            bad += not (least <= float(day[name][b]) <= most)
    return bad
