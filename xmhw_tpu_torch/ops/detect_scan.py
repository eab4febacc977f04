"""Per-event statistics for the event table: the CUDA kernel and its plain
version.

:func:`event_stats` launches ``csrc/detect_scan.cu`` on a CUDA tensor and
runs :func:`event_stats_plain` on a CPU tensor. It replaces the TPU kernel
``xmhw_tpu/ops/pallas/detect_scan.py:fused_detect_scans`` together with
the end counting and boundary gather that ran on its state array
(``xmhw_tpu/core/features_scan.py:324-575``): both versions return each
event's results directly in its ``(K, C)`` slot.

Outputs, slot k of cell c holding the cell's k-th event (k < K):

* ``F`` (len(F_CHANNELS), K, C) in the series dtype. For relSeas (rs),
  relThresh (rt), severity (sv) and the absolute value (ma): the finite
  count, and the sum, mean (NaN without finite values) and sample
  standard deviation (NaN below two). The category-day counts and the
  finite-category count. The relSeas, severity and category maxima;
  relSeas at its first and last finite day; the anomaly ts - seas of the
  day before the first event day that has a finite one, and of the day
  after the last such day; relThresh and the absolute value at the relSeas
  peak. NaN where there is no such value.
* ``I`` (3, K, C) int32: start row, end row, peak row (-1 without a
  finite relSeas).

Slots from min(n_events, K) on are NaN / -1.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

F_CHANNELS = (
    "n_rs", "sum_rs", "mean_rs", "std_rs",
    "n_rt", "sum_rt", "mean_rt", "std_rt",
    "n_sv", "sum_sv", "mean_sv", "std_sv",
    "n_ma", "sum_ma", "mean_ma", "std_ma",
    "dur_moderate", "dur_strong", "dur_severe", "dur_extreme", "n_ct",
    "max_rs", "max_sv", "max_ct",
    "relS_first", "relS_last", "anom_first", "anom_last",
    "relT_peak", "mabs_peak",
)
I_CHANNELS = ("start", "end", "peak")


def event_stats_plain(ts, th, se, doy_pos, day, is_start, K):
    """Plain torch version: a segmented reduction over the event slot
    (cumsum(is_start) - 1); two-pass variances.

    Sums add each event's days in time order, one after the other from
    0.0 (``torch.segment_reduce`` over the days taken cell by cell), so
    their bits are the same from run to run and on the CPU and CUDA: no
    atomics, no order that depends on the launch. Maxima and minima
    (``scatter_reduce_``) do not depend on the order. Only the standard
    deviations may differ between the two by one ulp: float64
    ``torch.sqrt`` rounds correctly on CUDA and not always on the CPU.

    The order on CUDA rests on how torch's CUDA ``segment_reduce`` kernel
    treats a 2-D input with an inner size of 1 (one thread a segment, in
    order), which torch does not document; checked on torch 2.11.0+cu128,
    where a 1-D input already gives other bits. A later torch may change
    it: ``tests/test_torch_cuda.py::test_float64_detect_repeats_its_bits``
    and ``chip_smoke.py``'s float64 repeats guard it on the card."""
    T, C = ts.shape
    dt, dev = ts.dtype, ts.device
    nan = float("nan")
    big = 4 * T + 64
    pos = doy_pos.long()
    thresh_t = th.index_select(0, pos)
    seas_t = se.index_select(0, pos)
    anom = ts - seas_t
    pad = torch.full((1, C), nan, dtype=dt, device=dev)
    anom_prev = torch.cat([pad, anom[:-1]])  # anomaly of day t-1
    anom_next = torch.cat([anom[1:], pad])   # anomaly of day t+1

    slot = torch.cumsum(is_start.to(torch.int32), dim=0,
                        dtype=torch.int32) - 1
    n_events = is_start.sum(dim=0, dtype=torch.int32)
    # the days cell by cell, each cell's in time order: every event's
    # days are contiguous, the events of a cell in slot order
    c_idx, t_idx = torch.nonzero((day & (slot < K)).T, as_tuple=True)
    s_idx = slot[t_idx, c_idx].long()
    seg = s_idx * C + c_idx
    lengths = torch.bincount(c_idx * K + s_idx, minlength=C * K)
    t_ev = t_idx.to(torch.int64)
    x = ts[t_idx, c_idx]
    h = thresh_t[t_idx, c_idx]
    e = seas_t[t_idx, c_idx]
    rs = x - e
    rt = x - h
    thse = h - e
    sv = rs / -thse
    ct = torch.floor(1.0 + rt / thse)
    KC = K * C

    def seg_sum(v):
        # a 2-D input: on CUDA one thread sums each segment in order (a
        # 1-D input takes a tree reduction there, other bits than the CPU)
        s = torch.segment_reduce(v[:, None], "sum", lengths=lengths,
                                 initial=0.0, unsafe=True)
        return s.view(C, K).T.reshape(KC)

    def seg_reduce(v, how, init):
        out = torch.full((KC,), init, dtype=v.dtype, device=dev)
        return out.scatter_reduce_(0, seg, v, how, include_self=True)

    def moments(v):
        fin = torch.isfinite(v)
        n = seg_sum(fin.to(dt))
        s = seg_sum(torch.where(fin, v, 0.0))
        mean = s / torch.clamp(n, min=1.0)
        d = torch.where(fin, v - mean[seg], 0.0)
        m2 = seg_sum(d * d)
        std = torch.sqrt(torch.clamp(m2 / torch.clamp(n - 1.0, min=1.0),
                                     min=0.0))
        return (n, torch.where(n > 0, s, nan), torch.where(n > 0, mean, nan),
                torch.where(n > 1, std, nan))

    def seg_max(v):
        fin = torch.isfinite(v)
        return seg_reduce(torch.where(fin, v, -torch.inf), "amax",
                          -torch.inf), seg_sum(fin.to(dt))

    m_rs, m_rt, m_sv, m_ma = moments(rs), moments(rt), moments(sv), moments(x)
    n_rs = m_rs[0]
    fin_rs = torch.isfinite(rs)
    max_rs, _ = seg_max(rs)
    max_sv, n_sv = seg_max(sv)
    max_ct, n_ct = seg_max(ct)
    at_max = fin_rs & (rs == max_rs[seg])
    peak = seg_reduce(torch.where(at_max, t_ev, big), "amin", big)
    i_first = seg_reduce(torch.where(fin_rs, t_ev, big), "amin", big)
    i_last = seg_reduce(torch.where(fin_rs, t_ev, -1), "amax", -1)
    ap = anom_prev[t_idx, c_idx]
    am = anom_next[t_idx, c_idx]
    i_ap = seg_reduce(torch.where(torch.isfinite(ap), t_ev, big), "amin",
                      big)
    i_am = seg_reduce(torch.where(torch.isfinite(am), t_ev, -1), "amax", -1)
    start = seg_reduce(t_ev, "amin", big)
    end = seg_reduce(t_ev, "amax", -1)

    cols = torch.arange(C, device=dev).repeat(K)

    def pick(src, rows, ok):
        return torch.where(ok, src[torch.clamp(rows, 0, T - 1), cols], nan)

    anyr = n_rs > 0
    fch = [
        *m_rs, *m_rt, *m_sv, *m_ma,
        seg_sum((ct == 1.0).to(dt)), seg_sum((ct == 2.0).to(dt)),
        seg_sum((ct == 3.0).to(dt)), seg_sum((ct >= 4.0).to(dt)), n_ct,
        torch.where(anyr, max_rs, nan), torch.where(n_sv > 0, max_sv, nan),
        torch.where(n_ct > 0, max_ct, nan),
        pick(ts, i_first, anyr) - pick(seas_t, i_first, anyr),
        pick(ts, i_last, anyr) - pick(seas_t, i_last, anyr),
        pick(anom_prev, i_ap, i_ap < big), pick(anom_next, i_am, i_am >= 0),
        pick(ts, peak, anyr) - pick(thresh_t, peak, anyr),
        pick(ts, peak, anyr),
    ]
    ich = [start, end, torch.where(anyr, peak, -1)]
    used = (torch.arange(K, device=dev)[:, None]
            < torch.clamp(n_events, max=K)[None, :]).reshape(KC)
    F = torch.where(used, torch.stack(fch), nan).view(len(F_CHANNELS), K, C)
    Ic = torch.where(used, torch.stack(ich), -1).to(torch.int32)
    return F, Ic.view(len(I_CHANNELS), K, C)


def event_stats(ts, th, se, doy_pos, day, is_start, K):
    """Per-event statistics (see the module docstring).

    ts: (T, C) float32; th/se: (ndoy, C) float32; doy_pos: (T,) int32 rows
    of th/se, each in [0, ndoy); day/is_start: (T, C) bool, the RLE's
    ``event_day``/``is_start``. Returns (F, I). CPU tensors run the plain
    version.
    """
    if not ts.is_cuda:
        return event_stats_plain(ts, th, se, doy_pos, day, is_start, K)
    T, C = ts.shape
    dev = ts.device
    want = {"ts": (ts, torch.float32, (T, C)),
            "th": (th, torch.float32, (th.shape[0], C)),
            "se": (se, torch.float32, (th.shape[0], C)),
            "doy_pos": (doy_pos, torch.int32, (T,)),
            "day": (day, torch.bool, (T, C)),
            "is_start": (is_start, torch.bool, (T, C))}
    for name, (t, dtype, shape) in want.items():
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise TypeError(f"event_scan kernel: {name} must be contiguous "
                            f"{dtype} {shape} on {dev}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    args = (ts, th, se, doy_pos, day, is_start)
    lib = _build.library()
    # the kernel's per-event records, copied into F and I at its end
    recs = torch.empty(lib.xmhw_event_scan_scratch(C, K),
                       dtype=torch.float32, device=dev)
    F = torch.empty((len(F_CHANNELS), K, C), dtype=torch.float32,
                    device=dev)
    Ic = torch.empty((len(I_CHANNELS), K, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(ts.device):
        err = lib.xmhw_event_scan(
            *(a.data_ptr() for a in args), T, C, K, recs.data_ptr(),
            F.data_ptr(), Ic.data_ptr(), _build.stream_of(ts))
    _build.check(err, "event_scan")
    event_stats.launches += 1
    return F, Ic


event_stats.launches = 0


def launch_config():
    """The kernel's launch shape per block: ``warps`` (time segments),
    ``threads`` and ``smem_bytes`` (dynamic shared memory). Builds the
    kernel library on first use."""
    vals = [ctypes.c_int() for _ in range(3)]
    _build.library().xmhw_event_scan_config(*map(ctypes.byref, vals))
    return dict(zip(("warps", "threads", "smem_bytes"),
                    (v.value for v in vals)))
