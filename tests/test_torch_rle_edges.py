"""Inputs that stress the time segments of the RLE kernel, and checks that
each input has the geometry its name promises.

``csrc/rle.cu`` splits time into WARPS segments of L = ceil(T / WARPS)
days, one per warp, and settles the runs and gaps that cross a segment
edge afterwards. :func:`edge_mask` builds (T, C) exceedance masks with
runs and gaps placed against those edges. ``tests/test_torch_cuda.py``
holds the kernel to its plain version on them (CASES' card shapes), and
``tests/test_torch_events.py`` holds the plain version to the JAX package
(CASES' CPU shapes). This file imports neither JAX nor the JAX package.

Outside the placed runs the mask is True on ~12 % of days at random: short
runs, most of them dropped. Every placed pattern clears two days on each
side of itself first, so its gaps are as long as stated.
"""

from typing import NamedTuple

import numpy as np
import pytest

WARPS = 32  # time segments of csrc/rle.cu (kWarps)


class Case(NamedTuple):
    T_card: int
    T_cpu: int
    C_card: int
    C_cpu: int
    rle: dict  # keywords of mhw_filter besides the defaults


CASES = {
    "across_edge": Case(14610, 2000, 64, 40, {}),
    # runs over three segments, and at the card's T over five
    "three_segments": Case(14610, 2000, 64, 40, {}),
    "start_at_edge": Case(14610, 2000, 64, 40, {}),
    "end_before_edge": Case(14610, 2000, 64, 40, {}),
    # kept runs on both sides of an edge, gaps of 1, max_gap, max_gap + 1
    "gaps_at_edge": Case(14610, 2000, 64, 40, {"max_gap": 3}),
    # a dropped 2-day run on the edge, in a gap of 6 (joined) or 7 days
    "dropped_in_gap": Case(14610, 2000, 64, 40, {"max_gap": 6}),
    "join_chain": Case(14610, 2000, 64, 40, {}),
    "all_true": Case(14610, 2000, 64, 40, {}),
    "all_false": Case(14610, 2000, 64, 40, {}),
    "quirk_first_edge": Case(14610, 2000, 64, 40,
                             {"day0_fillna_quirk": True}),
    "no_join": Case(14610, 2000, 64, 40, {"join_gaps": False}),
    # T below WARPS: one-day segments and empty ones
    "T1": Case(1, 1, 64, 40, {"min_duration": 1}),
    "T7": Case(7, 7, 64, 40, {"min_duration": 2, "max_gap": 1}),
    "T15": Case(15, 15, 64, 40, {"min_duration": 3,
                                 "day0_fillna_quirk": True}),
    # a block with one live lane of 32
    "C33": Case(14610, 2000, 33, 33, {}),
    # 128 lanes: the TPU kernel's width (its interpret mode runs it)
    "lanes128": Case(14610, 700, 128, 128, {}),
}


def segment_edges(T, warps=WARPS):
    """First days of the segments after the first one."""
    L = -(-T // warps)
    return [w * L for w in range(1, warps) if w * L < T]


def kwargs(name):
    """mhw_filter's keywords for case ``name``: the defaults (min_duration
    5, join_gaps, max_gap 2, no day-0 quirk) updated by the case's."""
    kw = dict(min_duration=5, join_gaps=True, max_gap=2,
              day0_fillna_quirk=False)
    kw.update(CASES[name].rle)
    return kw


def edge_mask(name, T, C, warps=WARPS, seed=0):
    """(T, C) bool exceedance mask of case ``name``."""
    rng = np.random.default_rng(seed)
    if name in ("T1", "T7", "T15"):
        m = rng.random((T, C)) < 0.6
        m[:, 0] = True    # one run over every segment
        m[:, 1] = False   # no run at all
        m[0, 2::2] = True  # runs touching day 0
        if T == 15:  # from day 0: exactly min_duration (3), and 4 days
            m[:4, 3] = [True, True, True, False]
            m[:5, 4] = [True, True, True, True, False]
        return m
    if name == "all_true":
        return np.ones((T, C), bool)
    if name == "all_false":
        return np.zeros((T, C), bool)
    m = rng.random((T, C)) < 0.12
    L = -(-T // warps)
    edges = segment_edges(T, warps)

    def put(c, runs):  # clear 2 days around, then set each (start, length)
        lo = min(s for s, _ in runs)
        hi = max(s + n for s, n in runs)
        m[max(lo - 2, 0):min(hi + 2, T), c] = False
        for s, n in runs:
            m[max(s, 0):min(s + n, T), c] = True

    for c in range(C):
        if name == "three_segments":
            put(c, [(L // 2 + c % 7, int(2.3 * L))])
            if c % 3 == 0 and 10 * L < T:  # over segments 5 .. 9
                put(c, [(6 * L - 3 - c % 4, 3 * L + 6)])
            continue
        if name == "join_chain":  # 5-day runs, 2-day gaps, over 3 edges
            s0 = L - 10 - c % 7
            put(c, [(s, 5) for s in range(s0, s0 + 3 * L, 7)])
            continue
        if name == "quirk_first_edge":
            k = c % 4
            if k == 0:    # from day 0 across the first edge
                put(c, [(0, L + 3 + c % 5)])
            elif k == 1:  # exactly min_duration from day 0: dropped
                put(c, [(0, 5)])
            elif k == 2:  # one day more: kept, without day 0
                put(c, [(0, 6)])
            else:         # across the first edge, then joined
                put(c, [(0, L + 1 + c % 3), (L + 3 + c % 3, 6)])
            continue
        for i, e in enumerate(edges):
            if name in ("across_edge", "C33", "lanes128"):
                s = e - 1 - (c + i) % 6
                put(c, [(s, 7 + (c + i) % 7)])
            elif name == "start_at_edge":
                put(c, [(e, 3 if c % 4 == 3 else 5 + (c + i) % 7)])
            elif name == "end_before_edge":
                n = 4 if c % 4 == 3 else 5 + (c + i) % 7
                put(c, [(e - n, n)])
            elif name in ("gaps_at_edge", "no_join"):
                gaps = (1, 3, 4) if name == "gaps_at_edge" else (1, 2)
                g = gaps[(c + i) % len(gaps)]
                if g == 1:  # the gap day is e - 1 or e
                    gs = e - (c // 3) % 2
                else:       # the gap holds e - 1 and e
                    gs = e - 1 - (c // 3) % (g - 1)
                put(c, [(gs - 6, 6), (gs + g, 6)])
            elif name == "dropped_in_gap":
                gap = 6 if c % 2 == 0 else 7
                put(c, [(e - 9, 6), (e - 1, 2), (e - 3 + gap, 6)])
    return m


def runs(col):
    """[(start, end)] of the True runs of a 1-D bool array."""
    x = np.concatenate([[False], col, [False]]).astype(np.int8)
    d = np.diff(x)
    return list(zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1) - 1))


def filtered(name, T, C):
    """The case's mask and the port's plain RLE of it (numpy arrays)."""
    import torch

    from xmhw_tpu_torch.ops import rle

    m = edge_mask(name, T, C)
    f = rle.mhw_filter_plain(torch.from_numpy(m), **kwargs(name))
    return m, {k: v.numpy() for k, v in f.items()}


def _gap_at(m, day, c, e):
    """(first, last) of the False run at edge e of cell c (the one holding
    e - 1, else e), or None when both days are True."""
    for t in (e - 1, e):
        if not m[t, c]:
            lo, hi = t, t
            while lo > 0 and not m[lo - 1, c]:
                lo -= 1
            while hi + 1 < len(m) and not m[hi + 1, c]:
                hi += 1
            return lo, hi
    return None


def check_geometry(name, T, C):
    """Assert that case ``name`` at (T, C) holds what its name promises."""
    m, f = filtered(name, T, C)
    kw = kwargs(name)
    day, start, end = f["event_day"], f["is_start"], f["ev_end"]
    L = -(-T // WARPS)
    edges = segment_edges(T)
    spans = [(c, s, end[s, c]) for c in range(C)
             for s in np.flatnonzero(start[:, c])]
    assert len(spans) == f["n_events"].sum()

    def crosses(s, e, x):
        return s < x <= e

    if name in ("across_edge", "C33", "lanes128"):
        for x in edges:
            assert any(crosses(s, e, x) for _, s, e in spans), (name, x)
        if name == "C33":
            assert C == 33 and any(c == 32 and any(crosses(s, e, x)
                                                   for x in edges)
                                   for c, s, e in spans)
        if name == "lanes128":
            assert C == 128
    elif name == "three_segments":
        most = max(e // L - s // L for _, s, e in spans)
        assert most >= (4 if T == 14610 else 2), most
    elif name == "start_at_edge":
        for x in edges:
            assert any(start[x, c] and not m[x - 1, c] for c in range(C))
    elif name == "end_before_edge":
        for x in edges:
            assert any(e == x - 1 and not m[x, c] for c, _, e in spans)
    elif name in ("gaps_at_edge", "no_join"):
        seen = set()
        for c in range(C):
            for x in edges:
                gap = _gap_at(m, day, c, x)
                if gap is None or gap[0] == 0 or gap[1] == T - 1:
                    continue
                lo, hi = gap
                if not (day[lo - 1, c] and day[hi + 1, c]):
                    continue  # not between two kept runs
                g = hi - lo + 1
                joined = bool(day[lo:hi + 1, c].all())
                assert joined == (kw["join_gaps"] and g <= kw["max_gap"])
                seen.add(g)
        want = {1, 3, 4} if name == "gaps_at_edge" else {1, 2}
        assert want <= seen, seen
    elif name == "dropped_in_gap":
        joined = set()
        for c in range(C):
            for x in edges:
                short = [(s, e) for s, e in runs(m[:, c])
                         if s <= x - 1 and x <= e]
                if short and short[0][1] - short[0][0] + 1 < 5:
                    joined.add(bool(day[x, c]))
        assert joined == {True, False}
    elif name == "join_chain":
        def joined_edges(c):
            return sum(1 for x in edges if day[x - 1, c] and day[x, c]
                       and not (m[x - 1, c] and m[x, c]))
        assert max(joined_edges(c) for c in range(C)) >= 2
    elif name == "all_true":
        assert day.all() and (f["n_events"] == 1).all()
    elif name == "all_false":
        assert not day.any() and (f["n_events"] == 0).all()
    elif name == "quirk_first_edge":
        assert kw["day0_fillna_quirk"]
        assert any(m[0, c] and not day[0, c] and start[1, c]
                   and end[1, c] >= L for c in range(C))
        assert any(m[:5, c].all() and not m[5, c] and not day[:5, c].any()
                   for c in range(C))
    elif name in ("T1", "T7", "T15"):
        assert T < WARPS and len(segment_edges(T)) == T - 1
        assert spans[0][1:] == (kw["day0_fillna_quirk"] * 1, T - 1)
        if name == "T15":
            assert not day[:3, 3].any() and day[1:4, 4].all()


@pytest.mark.parametrize("where", ["card", "cpu"])
@pytest.mark.parametrize("name", list(CASES))
def test_cases_have_their_geometry(name, where):
    """Each case at each of its shapes holds what its name promises (at
    the card's T on 8 cells: the patterns repeat every few cells)."""
    pytest.importorskip("torch")
    case = CASES[name]
    T = case.T_card if where == "card" else case.T_cpu
    C = case.C_card if where == "card" else case.C_cpu
    if where == "card" and T > 2000 and name not in ("C33", "lanes128"):
        C = 8
    check_geometry(name, T, C)


def test_segments_cover_the_series():
    """The edges split T into WARPS segments of L days, the last ones
    shorter or empty, for every T of the cases."""
    for T in {c.T_card for c in CASES.values()} | {
            c.T_cpu for c in CASES.values()}:
        L = -(-T // WARPS)
        ends = [0] + segment_edges(T) + [T]
        assert all(b - a == L for a, b in zip(ends[:-2], ends[1:-1]))
        assert 0 < ends[-1] - ends[-2] <= L
