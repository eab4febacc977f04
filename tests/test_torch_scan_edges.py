"""Inputs that stress the time segments of the event-scan kernel, and
checks that each input has the geometry its name promises.

``csrc/detect_scan.cu`` splits time into WARPS segments of
L = ceil(T / WARPS) days, one per warp, and joins the events that cross a
segment edge afterwards. :func:`edge_inputs` builds (ts, th, se, doy_pos)
with events placed against those edges. ``tests/test_torch_cuda.py`` holds
the kernel to its plain version on them (CASES' card shapes) and
``tests/test_torch_detect.py`` holds the plain version to the JAX package
(CASES' CPU shapes). This file imports neither JAX nor the JAX package.

Thresholds are 0.5 and the climatological mean 0 everywhere, except two
extra rows of th/se (EXTRA, EXTRA + 1) that some days point at through
doy_pos, with seas NaN in chosen cells. Days outside an event lie in
[-0.5, 0.4), event days in [0.55, 2.5): categories 1 to 4 and above.
"""

from typing import NamedTuple

import numpy as np
import pytest

WARPS = 16  # time segments per block of csrc/detect_scan.cu (kWarps)
EXTRA = 40  # doy rows of the climatology before the two extra rows


class Case(NamedTuple):
    T_card: int
    T_cpu: int
    C_card: int
    C_cpu: int
    K: int
    rle: dict  # keywords of the RLE (mhw_filter / detect_kernel)


CASES = {
    # one event over more than two segments (several thousand days)
    "long": Case(14610, 2000, 64, 40, 128, {}),
    "start_at_edge": Case(14610, 2000, 64, 40, 128, {}),
    "end_at_edge": Case(14610, 2000, 64, 40, 128, {}),
    # a start on the first day after a segment, one gap day after an event
    "start_after_edge": Case(14610, 2000, 64, 40, 128,
                             {"join_gaps": False}),
    "nan_before_edge": Case(14610, 2000, 64, 40, 128, {}),
    "nan_seas_start": Case(14610, 2000, 64, 40, 128, {}),
    # K = 3: the events past the third, which cross edges, are dropped
    "overflow": Case(14610, 2000, 64, 40, 3, {}),
    "all_event_all_nan": Case(14610, 2000, 64, 40, 128, {}),
    # T below WARPS: one-day segments and empty ones
    "T1": Case(1, 1, 64, 40, 4, {"min_duration": 1}),
    "T7": Case(7, 7, 64, 40, 4, {"min_duration": 2, "max_gap": 1}),
    # a block with one live lane of 32
    "C33": Case(14610, 2000, 33, 33, 128, {}),
}


def segment_edges(T, warps=WARPS):
    """First days of the segments after the first one."""
    L = -(-T // warps)
    return [w * L for w in range(1, warps) if w * L < T]


def edge_inputs(name, T, C, warps=WARPS, seed=0):
    """(ts, th, se, doy_pos) of case ``name`` at (T, C): float32 arrays,
    th/se (EXTRA + 2, C), doy_pos (T,) int32."""
    rng = np.random.default_rng(seed)
    doy_pos = (np.arange(T) % EXTRA).astype(np.int32)
    th = np.full((EXTRA + 2, C), 0.5)
    se = np.zeros((EXTRA + 2, C))
    if name in ("T1", "T7"):
        ts = rng.uniform(-0.2, 1.2, (T, C))
        ts[:, 0] = 1.0        # all event
        ts[:, 1] = np.nan     # all NaN
        return _cast(ts, th, se, doy_pos)
    ts = rng.uniform(-0.5, 0.4, (T, C))

    def paint(c, s, n):  # an event of n days from day s in cell c
        lo, hi = max(s, 0), min(s + n, T)
        ts[lo:hi, c] = 0.55 + 1.95 * rng.random(hi - lo)

    L = -(-T // warps)
    for c in range(C):
        if name == "overflow" and c % 3 == 0:
            continue  # these cells' third event crosses an edge
        for w in range(warps):  # one event inside each segment
            paint(c, w * L + L // 2 - 3 + c % 5, 5 + c % 3)
    for i, e in enumerate(segment_edges(T, warps)):
        for c in range(C):
            n = 5 + (c + i) % 7
            if name == "start_at_edge":
                paint(c, e, n)
            elif name == "end_at_edge":
                paint(c, e - n, n)
                if c % 2:
                    paint(c, e + 3, 6)  # after a 3-day gap: not joined
            elif name == "start_after_edge":
                paint(c, e - 7, 6)      # ends 2 days before the edge
                paint(c, e, n)
            elif name == "nan_before_edge":
                if c % 2:
                    paint(c, e, n)
                    ts[e - 1, c] = np.nan
                else:
                    paint(c, e - 4, 9)  # seas NaN at e - 1 (row EXTRA)
            elif name == "nan_seas_start":
                paint(c, e if c % 2 == 0 else e - 3, 8)
            else:  # an event across the edge, ending on e .. e + 12
                paint(c, e - 1 - (c + 3 * i) % 6, 7 + (c + i) % 7)
        if name == "nan_before_edge":
            doy_pos[e - 1] = EXTRA
        elif name == "nan_seas_start":
            doy_pos[e] = doy_pos[e - 3] = EXTRA + 1
    if name == "nan_before_edge":
        se[EXTRA, ::2] = np.nan
    elif name == "nan_seas_start":
        se[EXTRA + 1, np.arange(C) % 3 != 2] = np.nan
    elif name == "long":
        for c in range(0, C, 5):
            paint(c, L // 2 + c, int(3.3 * L))
    elif name == "all_event_all_nan":
        paint(0, 0, T)
        ts[:, 1] = np.nan
        paint(2, 0, T)
        ts[T // 2 + 1, 2] = np.nan  # two events over many segments
    return _cast(ts, th, se, doy_pos)


def _cast(ts, th, se, doy_pos):
    return (np.ascontiguousarray(ts, np.float32),
            np.ascontiguousarray(th, np.float32),
            np.ascontiguousarray(se, np.float32), doy_pos)


def event_spans(name, T, C, warps=WARPS):
    """[(cell, start, end)] of the events the port's plain RLE finds in
    case ``name``, and its raw event counts per cell."""
    import torch

    from xmhw_tpu_torch.ops import rle

    ts, th, se, pos = edge_inputs(name, T, C, warps)
    exceed = torch.from_numpy(ts) > torch.from_numpy(th)[torch.from_numpy(
        pos).long()]
    f = rle.mhw_filter_plain(exceed, full=False, **CASES[name].rle)
    day = f["event_day"].numpy()
    spans = []
    for c in range(C):
        for s in np.flatnonzero(f["is_start"][:, c].numpy()):
            e = s
            while e + 1 < T and day[e + 1, c]:
                e += 1
            spans.append((c, int(s), int(e)))
    return spans, f["n_events"].numpy()


@pytest.mark.parametrize("where", ["card", "cpu"])
def test_cases_have_their_geometry(where):
    """Each case at each of its shapes holds what its name promises."""
    pytest.importorskip("torch")
    for name, case in CASES.items():
        T = case.T_card if where == "card" else case.T_cpu
        C = case.C_card if where == "card" else case.C_cpu
        if where == "card" and T > 2000:
            C = 4  # the geometry repeats per cell; keep the CPU run short
        spans, n_events = event_spans(name, T, C)
        L = -(-T // WARPS)
        ed = set(segment_edges(T))
        assert spans and len(spans) == n_events.sum(), name
        crossing = [(s, e) for _, s, e in spans
                    if any(s < x <= e for x in ed)]
        if name == "long":
            assert max(e - s for _, s, e in spans) > 3 * L
            if T == 14610:
                assert max(e - s for _, s, e in spans) > 2000
        elif name in ("start_at_edge", "start_after_edge"):
            assert ed <= {s for _, s, _ in spans}, name
        elif name == "end_at_edge":
            assert {x - 1 for x in ed} <= {e for _, _, e in spans}
        elif name == "overflow":
            assert n_events.max() > case.K
            assert any(s < x <= e for c, s, e in spans for x in ed
                       if sum(1 for c2, s2, _ in spans
                              if c2 == c and s2 < s) >= case.K)
        elif name in ("T1", "T7"):
            assert T < WARPS and spans[0][1:] == (0, T - 1)
        if name not in ("start_at_edge", "start_after_edge", "end_at_edge",
                        "T1"):
            assert crossing, name


def test_nan_cases_put_nan_where_promised():
    T, C = CASES["nan_before_edge"].T_cpu, 4
    ts, _, se, pos = edge_inputs("nan_before_edge", T, C)
    ts2, _, se2, pos2 = edge_inputs("nan_seas_start", T, C)
    for x in segment_edges(T):
        anom = ts[x - 1] - se[pos[x - 1]]
        assert np.isnan(anom).all()  # odd cells: ts NaN; even: seas NaN
        assert (ts[x - 1, ::2] > 0.5).all()  # even cells: an event day
        assert np.isnan(se2[pos2[x], 0]) and ts2[x, 0] > 0.5
