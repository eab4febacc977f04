"""The benchmark's plain reference against the repository's test oracle
and against the port's float64 CPU path, on seeded small series; and a
static check that the reference imports nothing of JAX or of either
package."""

from __future__ import annotations

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import calendar, clim, oracle, stats
from benchmark.reference.judge import Setup, judge, table_cases

ROOT = Path(__file__).resolve().parents[2]


def _test_oracle():
    spec = importlib.util.spec_from_file_location(
        "repo_test_oracle", ROOT / "tests" / "oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def daily(y0, y1):
    return np.arange(f"{y0}-01-01", f"{y1 + 1}-01-01",
                     dtype="datetime64[D]").astype("datetime64[ns]")


def series(T, m, seed, period=365.25):
    rng = np.random.default_rng(seed)
    step = np.arange(T)[:, None]
    noise = np.cumsum(rng.normal(0, 0.4, (T, m)), axis=0) * 0.2
    return (15 + 3 * np.sin(2 * np.pi * step / period) + noise
            + rng.normal(0, 0.6, (T, m))).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 2])
def test_copy_matches_the_test_oracle(seed):
    t = daily(2000, 2003)
    x = series(len(t), 3, seed).astype(np.float64)
    x[100:103, 1] = np.nan
    doy = calendar.doy366(t)
    orig = _test_oracle()
    for j in range(x.shape[1]):
        th0, se0 = orig.clim_oracle(x[:, j], doy, 366)
        th1, se1 = oracle.clim_oracle(x[:, j], doy, 366)
        np.testing.assert_array_equal(th0, th1)
        np.testing.assert_array_equal(se0, se1)
        e0 = orig.events_oracle(x[:, j], th0[doy - 1], se0[doy - 1])
        e1 = oracle.events_oracle(x[:, j], th1[doy - 1], se1[doy - 1])
        assert len(e0) == len(e1) > 0
        for a, b in zip(e0, e1):
            assert a.keys() == b.keys()
            np.testing.assert_array_equal([a[k] for k in a],
                                          [b[k] for k in a])


@pytest.mark.parametrize("tstep", [False, True])
def test_clim_many_matches_the_oracle(tstep):
    if tstep:
        t = np.array([np.datetime64(f"{y}-{m:02d}-15", "ns")
                      for y in range(1990, 2010) for m in range(1, 13)])
        x = series(len(t), 4, 3, period=12)
    else:
        t = daily(2001, 2004)
        x = series(len(t), 4, 4)
    x[5:9, 2] = np.nan
    doy, ndoy = calendar.rows(t, tstep)
    th, se = clim.clim_many(x, doy, ndoy, feb29=not tstep)
    for j in range(x.shape[1]):
        t0, s0 = oracle.clim_oracle(x[:, j].astype(np.float64), doy, ndoy,
                                    feb29=not tstep)
        np.testing.assert_allclose(th[:, j], t0, rtol=0, atol=1e-12)
        np.testing.assert_allclose(se[:, j], s0, rtol=0, atol=1e-12)


def test_calendar_matches_the_port():
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.xrlite import TimeIndex

    t = daily(1999, 2005)
    np.testing.assert_array_equal(calendar.doy366(t),
                                  compute_doy(TimeIndex(t))[0])
    m = np.array([np.datetime64(f"{y}-{k:02d}-15", "ns")
                  for y in range(1854, 1860) for k in range(1, 13)])
    d, n = compute_doy(TimeIndex(m), keep_tstep=True)
    np.testing.assert_array_equal(calendar.doy_tstep(m), d)
    assert calendar.rows(m, True)[1] == n == 12


def test_events_match_the_port_float64_point_path():
    from xmhw_tpu_torch.core.point import point_clim, point_detect

    t = daily(1995, 2002)
    x = series(len(t), 3, 7).astype(np.float64)
    doy = calendar.doy366(t)
    for j in range(x.shape[1]):
        th, se = point_clim(x[:, j:j + 1], doy, 5, 366, 90, True, 31, True)
        r_th, r_se = oracle.clim_oracle(x[:, j], doy, 366)
        np.testing.assert_allclose(th[:, 0], r_th, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(se[:, 0], r_se, rtol=1e-12, atol=1e-12)
        tab, n, _ = point_detect(x[:, j:j + 1], th, se,
                                 (doy - 1).astype(np.int32))
        ev = oracle.events_oracle(x[:, j], r_th[doy - 1], r_se[doy - 1])
        assert int(n[0]) == len(ev) > 0
        for k, e in enumerate(ev):
            for name, v in e.items():
                np.testing.assert_allclose(tab[name][k, 0], v, rtol=1e-9,
                                           atol=1e-9, err_msg=name)


def test_stats_match_the_port_float64_run_fused():
    """Year-bin event and day statistics against the port's float64 CPU
    run_fused, and the whole judge finding that run exact."""
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.pipeline import run_fused
    from xmhw_tpu_torch.xrlite import TimeIndex

    t = daily(1990, 1997)
    x = series(len(t), 6, 8).astype(np.float64)
    doy, ndoy = compute_doy(TimeIndex(t))
    years = calendar.years(t)
    bins = np.arange(1990, 1999)
    ybod = (np.searchsorted(bins, years, side="right") - 1).astype(np.int32)
    edges = tuple(int(v) for v in stats.day_edges(years, bins))
    th, se, tab, nev, ex = run_fused(
        x, doy, doy - 1, ybod_np=ybod, nbins=len(bins) - 1, day_edges=edges,
        device="cpu")
    for j in range(x.shape[1]):
        r_th, r_se = oracle.clim_oracle(x[:, j], doy, 366)
        ev = oracle.events_oracle(x[:, j], r_th[doy - 1], r_se[doy - 1])
        want = stats.event_stats(ev, years, bins)
        for name, v in want.items():
            np.testing.assert_allclose(ex["block"][name][:, j], v,
                                       rtol=1e-9, atol=1e-9, err_msg=name)
        cats = stats.categories(x[:, j], r_th[doy - 1], r_se[doy - 1])
        want = stats.day_stats(x[:, j], cats, stats.day_edges(years, bins))
        for name, v in want.items():
            np.testing.assert_allclose(ex["day"][name][:, j], v, rtol=1e-9,
                                       atol=1e-9, err_msg=name)
    cases = table_cases(x, th, se, tab, nev, range(x.shape[1]), "cpu",
                        block=ex["block"], day=ex["day"])
    r = judge(cases, Setup(dates=t, bins=bins), 1e-9).values
    assert r["clim_gap"] < 1e-12 and r["event_gap"] < 1e-9
    assert r["event_cells_off"] == r["event_fields_off"] == 0
    assert r["day_counts_off"] == 0 and r["block_gap"] < 1e-9


def test_float32_port_is_judged_correct_and_a_shifted_one_is_not():
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.pipeline import fused_threshold_detect
    from xmhw_tpu_torch.xrlite import TimeIndex

    t = daily(1990, 1995)
    x = series(len(t), 8, 9)
    doy, _ = compute_doy(TimeIndex(t))
    pos = torch.from_numpy((doy - 1).astype(np.int32))
    th, se, tab, nev = fused_threshold_detect(torch.from_numpy(x), doy, pos,
                                              K=64)
    host = {k: v.numpy() for k, v in tab.items()}
    cases = table_cases(x, th.numpy(), se.numpy(), host, nev.numpy(),
                        range(8), "f32")
    r = judge(cases, Setup(dates=t), 1e-3).values
    assert r["clim_gap"] < 1e-4 and r["event_gap"] < 1e-3
    assert r["event_cells_off"] == r["event_fields_off"] == 0
    shifted = table_cases(x, th.numpy() + 0.01, se.numpy(), host,
                          nev.numpy(), range(8), "f32")
    assert judge(shifted, Setup(dates=t), 1e-3).values["clim_gap"] > 5e-3


FORBIDDEN = {"jax", "jaxlib", "flax", "xmhw_tpu", "xmhw_tpu_torch"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_jax_nor_either_package():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for f in sorted((ROOT / "benchmark").rglob("*.py")):
        if "tests" in f.parts:
            continue
        for name in _imports(f):
            assert name.split(".")[0] not in {"jax", "jaxlib", "flax",
                                              "xmhw_tpu"}, (f, name)
