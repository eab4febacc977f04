"""Event detection and the 31-variable event table for one cell block.

Port of the contract of :func:`xmhw_tpu.core.features_scan.detect_kernel`
(reference: xmhw/features.py:22-295): the table variables
(``TABLE_VARS``), NaN / -1 padding to the capacity K, the RAW per-cell
event count (it may exceed K; callers detect overflow from it and retry),
and the ``intermediate`` per-day dict.

The pipeline is: exceedance mask -> event identification
(:mod:`xmhw_tpu_torch.ops.rle`) -> per-event statistics written straight
into each event's (K, C) slot (:mod:`xmhw_tpu_torch.ops.detect_scan`) ->
closed-form properties. The TPU engine's checkpoint mode, fold/latch
layout, two-level counting and grouped gathers are TPU layout choices and
have no counterpart here: the event-scan kernel writes each event's
results at its last day, so there is nothing to count or gather.
"""

from __future__ import annotations

import torch

from ..ops import detect_scan, rle

# the event-table variables, sorted (the JAX package's order)
TABLE_VARS = (
    "category", "duration", "duration_extreme", "duration_moderate",
    "duration_severe", "duration_strong", "event", "index_end",
    "index_peak", "index_start", "intensity_cumulative",
    "intensity_cumulative_abs", "intensity_cumulative_relThresh",
    "intensity_max", "intensity_max_abs", "intensity_max_relThresh",
    "intensity_mean", "intensity_mean_abs", "intensity_mean_relThresh",
    "intensity_var", "intensity_var_abs", "intensity_var_relThresh",
    "rate_decline", "rate_onset", "severity_cumulative", "severity_max",
    "severity_mean", "severity_var", "time_end", "time_peak",
    "time_start",
)
# the rankable subset — mhw_rank skips event/time/index variables
# (reference: xmhw/stats.py:482-486)
RANK_VARS = tuple(k for k in TABLE_VARS
                  if not any(x in k for x in ("event", "time", "index")))


def event_table(F, I, n_events, T):
    """Closed-form event properties from the per-event statistics
    (reference: features.py:161-295). F/I: the outputs of
    :func:`ops.detect_scan.event_stats`; n_events: (C,) raw counts."""
    ch = dict(zip(detect_scan.F_CHANNELS, F))
    K = F.shape[1]
    dt = F.dtype
    nan = float("nan")
    valid = (torch.arange(K, device=F.device)[:, None]
             < torch.clamp(n_events, max=K)[None, :])
    start, end, peak = I[0], I[1], I[2]
    any_rs = ch["n_rs"] > 0

    def masked(v, ok=valid):
        return torch.where(ok, v, nan)

    max_rs = masked(ch["max_rs"], valid & any_rs)
    startf = torch.where(valid, start, 0).to(dt)
    endf = torch.where(valid, end, 0).to(dt)
    peakf = torch.where(valid & any_rs, peak, 0).to(dt)
    relS_first = masked(ch["relS_first"])
    relS_last = masked(ch["relS_last"])

    tsend = float(T - 1)
    rel_peak = peakf - startf
    x = torch.where(rel_peak != 0, rel_peak, 1.0)
    onset_period = torch.where(startf == 0, x, x + 0.5)
    esp = endf - startf - rel_peak
    y = torch.where(rel_peak != tsend, esp, 1.0)
    decline_period = torch.where(endf == tsend, y, y + 0.5)
    edge_onset = 0.5 * (relS_first + torch.where(
        startf == 0, relS_first, masked(ch["anom_first"])))
    edge_decline = 0.5 * (relS_last + torch.where(
        endf == tsend, relS_last, masked(ch["anom_last"])))

    table = {
        "category": masked(torch.clamp(ch["max_ct"], max=4.0)),
        "duration": masked(endf - startf + 1.0),
        "duration_extreme": masked(ch["dur_extreme"]),
        "duration_moderate": masked(ch["dur_moderate"]),
        "duration_severe": masked(ch["dur_severe"]),
        "duration_strong": masked(ch["dur_strong"]),
        "event": masked(startf),
        "index_end": masked(endf),
        "index_peak": masked(peakf),
        "index_start": masked(startf),
        "intensity_cumulative": masked(ch["sum_rs"]),
        "intensity_cumulative_abs": masked(ch["sum_ma"]),
        "intensity_cumulative_relThresh": masked(ch["sum_rt"]),
        "intensity_max": max_rs,
        "intensity_max_abs": masked(ch["mabs_peak"]),
        "intensity_max_relThresh": masked(ch["relT_peak"]),
        "intensity_mean": masked(ch["mean_rs"]),
        "intensity_mean_abs": masked(ch["mean_ma"]),
        "intensity_mean_relThresh": masked(ch["mean_rt"]),
        "intensity_var": masked(ch["std_rs"]),
        "intensity_var_abs": masked(ch["std_ma"]),
        "intensity_var_relThresh": masked(ch["std_rt"]),
        "rate_decline": masked((max_rs - edge_decline) / decline_period),
        "rate_onset": masked((max_rs - edge_onset) / onset_period),
        "severity_cumulative": masked(ch["sum_sv"]),
        "severity_max": masked(ch["max_sv"]),
        "severity_mean": masked(ch["mean_sv"]),
        "severity_var": masked(ch["std_sv"]),
        "time_end": torch.where(valid, end, -1),
        "time_peak": torch.where(valid & any_rs, peak, -1),
        "time_start": torch.where(valid, start, -1),
    }
    return table


def _intermediate(ts, thresh_t, seas_t, bthresh, f):
    """The per-day intermediate dict (reference: xmhw.py:471-478)."""
    nan = float("nan")
    day = f["event_day"]
    relSeas = torch.where(day, ts - seas_t, nan)
    relThresh = torch.where(day, ts - thresh_t, nan)
    th_se = thresh_t - seas_t
    relThreshNorm = torch.where(day, relThresh / th_se, nan)
    cats = torch.floor(1.0 + relThreshNorm)
    return {
        "ts": ts,
        "seas": torch.where(day, seas_t, nan),
        "thresh": torch.where(day, thresh_t, nan),
        "bthresh": bthresh,
        "events": torch.where(day, f["event_id"].to(ts.dtype), nan),
        "relSeas": relSeas,
        "relThresh": relThresh,
        "relThreshNorm": relThreshNorm,
        "severity": torch.where(day, relSeas / -th_se, nan),
        "cats": cats,
        "duration_moderate": (cats == 1.0) & day,
        "duration_strong": (cats == 2.0) & day,
        "duration_severe": (cats == 3.0) & day,
        "duration_extreme": (cats >= 4.0) & day,
        "mabs": torch.where(day, ts, nan),
    }


def count_events(ts, th, doy_pos, min_duration=5, join_gaps=True,
                 max_gap=2, day0_fillna_quirk=False, use_kernels=False):
    """Events per cell (C,) int32: the counting pass that fixes K."""
    filt = rle.mhw_filter if use_kernels else rle.mhw_filter_plain
    bthresh = ts > th.index_select(0, doy_pos.long())
    return filt(bthresh, min_duration, join_gaps, max_gap,
                day0_fillna_quirk, full=False)["n_events"]


def detect_kernel(ts, th, se, doy_pos, K, min_duration=5, join_gaps=True,
                  max_gap=2, intermediate=False, day0_fillna_quirk=False,
                  use_kernels=False):
    """Detection for one (T, C) block.

    ts: (T, C); th/se: (ndoy, C) climatologies; doy_pos: (T,) int32 rows
    of th/se. ``use_kernels`` routes the RLE and the event scan through
    their CUDA kernels (float32 tensors on the GPU; CPU tensors take the
    plain versions either way). Returns (table dict of (K, C) tensors,
    n_events (C,) raw counts, intermediate dict of (T, C) tensors or {}).
    """
    T = ts.shape[0]
    thresh_t = th.index_select(0, doy_pos.long())
    bthresh = ts > thresh_t
    filt = rle.mhw_filter if use_kernels else rle.mhw_filter_plain
    f = filt(bthresh, min_duration, join_gaps, max_gap, day0_fillna_quirk,
             full=intermediate)
    scan = (detect_scan.event_stats if use_kernels
            else detect_scan.event_stats_plain)
    F, I = scan(ts, th, se, doy_pos, f["event_day"], f["is_start"], K)
    table = event_table(F, I, f["n_events"], T)
    inter = {}
    if intermediate:
        inter = _intermediate(ts, thresh_t, se.index_select(
            0, doy_pos.long()), bthresh, f)
    return table, f["n_events"], inter
