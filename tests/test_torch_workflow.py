"""The documented notebook workflow through the port's API on a small
daily box with land, against the plain reference of the benchmark
(``benchmark/reference``: ``clim.py``, ``oracle.py``, ``judge.py`` and
``workflow.py``), in float32 and float64; and the spans and counters of
the workflow's steps.

    clim = threshold(sst)
    mhw, inter = detect(sst, clim["thresh"], clim["seas"],
                        intermediate=True)
    blk = block_average(mhw, dstime=inter)
    rank, return_period = mhw_rank(mhw)

Tolerances: float64 runs the plain torch code, which the reference
matches to rounding: 1e-9 (absolute for the climatology, relative for
the rest) leaves a thousandfold room over float64's ~1e-12 and is far
below any decision's scale. float32 takes the benchmark cell's own limits
(``benchmark/limits/tasman_workflow.json``: ``clim_gap`` 1e-3 degC,
``event_gap`` 3e-3 relative), whose readings there are ~1e-5; every
decision (exceedance, event days and labels, categories, flags, day
counts, ranks) exact but where float32 can move it, on either side
within those limits, as the judge allows.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu_torch as xt  # noqa: E402
from benchmark.lib import inputs  # noqa: E402
from benchmark.reference import workflow  # noqa: E402
from benchmark.reference.judge import Case, Setup, judge, verdict  # noqa
from benchmark.reference.stats import EVENT_STATS  # noqa: E402
from xmhw_tpu_torch import utils  # noqa: E402
from xmhw_tpu_torch.xrlite import Coord, DataArray  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "benchmark/limits/tasman_workflow.json")
                    .read_text())
TIGHT = 1e-9  # float64 against float64: see the module docstring


def box(seed, ny=6, nx=8, years=(1982, 1985), land=0.3):
    """A (time, lat, lon) float32 box of daily series (the benchmark's
    ``smoothed_seasonal`` recipe), ``land`` of its cells all NaN."""
    dates = np.arange(f"{years[0]}-01-01", f"{years[1] + 1}-01-01",
                      dtype="datetime64[D]").astype("datetime64[ns]")
    n = ny * nx
    x = np.full((len(dates), n), np.nan, np.float32)
    ocean = np.sort(np.random.default_rng(seed).permutation(n)[
        :n - round(land * n)])
    x[:, ocean] = inputs.smoothed_seasonal(len(dates), len(ocean), seed,
                                           "cpu").numpy()
    lat = -44.875 + 0.25 * np.arange(ny)
    lon = 145.125 + 0.25 * np.arange(nx)
    da = DataArray(x.reshape(len(dates), ny, nx), ("time", "lat", "lon"),
                   {"time": Coord(("time",), dates),
                    "lat": Coord(("lat",), lat),
                    "lon": Coord(("lon",), lon)}, {"units": "degree_C"})
    return da, dates, ocean


def notebook(da, dtype):
    clim = xt.threshold(da, dtype=dtype, device="cpu")
    mhw, inter = xt.detect(da, clim["thresh"], clim["seas"],
                           intermediate=True, dtype=dtype, device="cpu")
    blk = xt.block_average(mhw, dstime=inter, device="cpu")
    rank, rp = xt.mhw_rank(mhw, device="cpu")
    return clim, mhw, inter, blk, rank, rp


def _at(ds, lat, lon):
    """The (lat, lon) index of a cell on a Dataset's own grid."""
    return (int(np.flatnonzero(np.asarray(ds.coords["lat"].values)
                               == lat)[0]),
            int(np.flatnonzero(np.asarray(ds.coords["lon"].values)
                               == lon)[0]))


def cells_of(da, ocean, out):
    """Each ocean cell's answers: (the judge's Case, the workflow
    comparison's dict)."""
    clim, mhw, inter, blk, rank, rp = out
    lat = np.asarray(da.coords["lat"].values)
    lon = np.asarray(da.coords["lon"].values)
    x = np.asarray(da.data)
    ev_all = np.asarray(mhw["event"].data)
    cases, cells = [], []
    for k in ocean:
        a, b = divmod(int(k), len(lon))
        where = f"lat {lat[a]} lon {lon[b]}"
        p, q = _at(clim, lat[a], lon[b])
        r, s = _at(mhw, lat[a], lon[b])
        i, j = _at(inter, lat[a], lon[b])
        u, v = _at(blk, lat[a], lon[b])
        rows = np.isfinite(ev_all[:, r, s])
        events = {n: np.asarray(mhw[n].data[:, r, s])[rows]
                  for n in mhw.keys()}
        th = np.asarray(clim["thresh"].data[:, p, q])
        se = np.asarray(clim["seas"].data[:, p, q])
        cases.append(Case(
            ts=x[:, a, b], th=th, se=se, events=events,
            rows=np.asarray(mhw.coords["events"].values)[rows],
            block={n: np.asarray(blk[n].data[:, u, v]) for n in EVENT_STATS},
            where=where))
        cells.append({
            "ts": x[:, a, b], "th": th, "se": se, "events": events,
            "inter": {n: np.asarray(inter[n].data[:, i, j])
                      for n in workflow.INTER_VARS},
            "day": {n: np.asarray(blk[n].data[:, u, v])
                    for n in workflow.DAY_STATS},
            "rank": {n: np.asarray(rank[n].data[:, r, s])[rows]
                     for n in rank.keys()},
            "rp": {n: np.asarray(rp[n].data[:, r, s])[rows]
                   for n in rp.keys()},
            "where": where})
    return cases, cells


@pytest.fixture(scope="module", params=[np.float32, np.float64],
                ids=["float32", "float64"])
def answered(request):
    da, dates, ocean = box(20_211)
    out = notebook(da, request.param)
    return request.param, da, dates, ocean, out


def _limits(dtype):
    if dtype == np.float64:
        return TIGHT, TIGHT
    return LIMITS["clim_gap"], LIMITS["event_gap"]


def test_climatology_events_and_block_statistics(answered):
    dtype, da, dates, ocean, out = answered
    clim_lim, ev_lim = _limits(dtype)
    cases, _ = cells_of(da, ocean, out)
    setup = Setup(dates=dates, bins=np.arange(1982, 1987))
    r = judge(cases, setup, clim_lim).values
    lim = {**LIMITS, "clim_gap": clim_lim, "event_gap": ev_lim,
           "block_gap": ev_lim}
    ok, rows = verdict(r, lim)
    assert ok, rows
    assert len(cases) == 34


def test_intermediate_day_statistics_ranks_and_return_periods(answered):
    dtype, da, dates, ocean, out = answered
    clim_lim, ev_lim = _limits(dtype)
    _, cells = cells_of(da, ocean, out)
    setup = Setup(dates=dates, bins=np.arange(1982, 1987))
    vals, worst, ref, products = workflow.check(cells, setup, clim_lim,
                                                ev_lim)
    nyears = workflow.n_years(dates, workflow.event_span(ref))
    vals["return_period_gap"] = workflow.return_period_gap([products],
                                                           nyears)
    lim = {**workflow.LIMITS, "inter_clim_gap": clim_lim,
           "inter_gap": ev_lim}
    if dtype == np.float64:
        lim["day_gap"] = TIGHT
    ok, rows = verdict(vals, lim)
    assert ok, (rows, worst)
    # the ranks were judged: every cell's events are the reference's
    assert sum(len(e) for e in ref) > 100
    assert 3.9 < nyears < 4.0


def test_intermediate_series_are_the_fifteen_of_the_reference(answered):
    _, da, _, ocean, out = answered
    inter = out[2]
    assert sorted(inter.keys()) == sorted(workflow.INTER_VARS)
    for n in workflow.INTER_VARS:
        assert inter[n].dims == ("time", "lat", "lon"), n
    # land cells are NaN throughout, ocean cells have their series
    ts = np.asarray(inter["ts"].data)
    assert np.isfinite(ts).all(axis=0).sum() == len(ocean)


def test_ranks_of_the_reference_follow_the_documented_tie_rule():
    # the port's host ranking's fixture (stats_api.rank_variable)
    got = workflow.ranks([2.3, 1.2, 3.5, 2.4, 2.3]).numpy()
    np.testing.assert_array_equal(got, [4, 5, 1, 2, 3])
    got = workflow.ranks([1.0, np.nan, 2.0]).numpy()
    np.testing.assert_array_equal(got, [2, np.nan, 1])
    got = xt.stats_api.rank_variable(np.array([2.3, 1.2, 3.5, 2.4, 2.3]))
    np.testing.assert_array_equal(got, [4, 5, 1, 2, 3])
    np.testing.assert_allclose(workflow.return_periods([1, 2], 3.0),
                               [4.0, 2.0])


def _spans(path):
    (f,) = list(Path(path).glob("*.json"))
    ev = json.loads(f.read_text())
    ev = ev["traceEvents"] if isinstance(ev, dict) else ev
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"][len("xmhw/"):]) for e in ev
            if e.get("ph") == "X" and str(e.get("name", "")).startswith(
                "xmhw/")]


def _inside(spans, inner, outer):
    outs = [(a, b) for a, b, n in spans if n == outer]
    ins = [(a, b) for a, b, n in spans if n == inner]
    return ins and all(any(a0 <= a and b <= b0 for a0, b0 in outs)
                       for a, b in ins)


def test_workflow_spans_and_counters(tmp_path, monkeypatch):
    monkeypatch.setattr(utils, "_counts", {})
    da, _, ocean = box(20_212)
    T = da.sizes["time"]
    with utils.trace(str(tmp_path)):
        clim, mhw, inter, blk, rank, rp = notebook(da, np.float32)
    sp = _spans(tmp_path)
    names = [n for _, _, n in sp]
    for n in ("assemble_inter", "inter_store", "block_average",
              "mhw_rank"):
        assert names.count(n) == 1, n
    assert _inside(sp, "assemble_inter", "detect")
    assert _inside(sp, "inter_store", "run_detect")
    # block_average and mhw_rank are public calls of their own
    assert not _inside(sp, "block_average", "detect")
    c = utils.counts()
    assert c["inter_calls"] == 1
    # fetched: ten float32 series and five bool flags of each ocean cell
    assert c["inter_bytes"] == len(ocean) * T * (10 * 4 + 5 * 1)
    assert c["inter_grid_bytes"] == sum(inter[k].data.nbytes
                                        for k in inter.keys())
    # no intermediate output, no intermediate count
    xt.detect(da, clim["thresh"], clim["seas"], device="cpu")
    assert utils.counts()["inter_calls"] == 1
    assert utils.counts()["inter_bytes"] == c["inter_bytes"]


def test_inter_bytes_count_every_block_of_cells(monkeypatch):
    """Two cell blocks fetch and store their intermediate columns each:
    the count is the whole grid's, as one block's."""
    monkeypatch.setattr(utils, "_counts", {})
    da, _, ocean = box(20_213)
    T = da.sizes["time"]
    clim = xt.threshold(da, device="cpu")
    _, one = xt.detect(da, clim["thresh"], clim["seas"],
                       intermediate=True, device="cpu")
    _, two = xt.detect(da, clim["thresh"], clim["seas"],
                       intermediate=True, device="cpu", cell_block=20)
    c = utils.counts()
    assert c["inter_calls"] == 2
    assert c["inter_bytes"] == 2 * len(ocean) * T * 45
    for k in one.keys():
        np.testing.assert_array_equal(np.asarray(one[k].data),
                                      np.asarray(two[k].data))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("cell_block", [None, 20], ids=["one", "blocks"])
def test_card_route_builds_the_host_route_grids(dtype, cell_block,
                                                monkeypatch):
    """detect(intermediate=True)'s card route (forced; here the torch
    code on the CPU), in one cell block or several: the intermediate
    Dataset equals the host route's bit for bit, in every variable's
    values, dtype, dims and coordinates, and in the order of the
    detect kernel's dict. A card call counts one ``inter_card_calls``
    and its grids' bytes in ``inter_bytes``; the host route counts the
    fetched arrays' bytes there, and no card call."""
    from xmhw_tpu_torch import api
    from xmhw_tpu_torch.core.features_scan import INTER_VARS

    da, _, ocean = box(20_214)
    T = da.sizes["time"]
    clim = xt.threshold(da, dtype=dtype, device="cpu")
    kw = dict(intermediate=True, dtype=dtype, device="cpu",
              cell_block=cell_block)
    monkeypatch.setattr(utils, "_counts", {})
    _, host = xt.detect(da, clim["thresh"], clim["seas"], **kw)
    c = utils.counts()
    assert "inter_card_calls" not in c
    size = np.dtype(dtype).itemsize
    assert c["inter_bytes"] == len(ocean) * T * (10 * size + 5 * 1)

    monkeypatch.setattr(api, "_inter_on_card", lambda *a: True)
    monkeypatch.setattr(utils, "_counts", {})
    _, card = xt.detect(da, clim["thresh"], clim["seas"], **kw)
    c = utils.counts()
    assert c["inter_card_calls"] == 1 and c["inter_calls"] == 1
    assert c["inter_bytes"] == c["inter_grid_bytes"] == sum(
        card[k].data.nbytes for k in card.keys())
    assert c["inter_bytes"] == 6 * 8 * T * (10 * size + 5 * 8)

    assert tuple(card.keys()) == tuple(host.keys()) == INTER_VARS
    for k in host.keys():
        got, want = card[k], host[k]
        assert got.dims == want.dims == ("time", "lat", "lon"), k
        assert got.data.dtype == want.data.dtype, k
        np.testing.assert_array_equal(got.data, want.data, err_msg=k)
        assert sorted(got.coords) == sorted(want.coords), k
        for n in want.coords:
            np.testing.assert_array_equal(got.coords[n].values,
                                          want.coords[n].values)
    assert host["bthresh"].data.dtype == np.float64
    assert host["ts"].data.dtype == dtype


@pytest.mark.parametrize("case", ["cpu", "none", "point", "no_host_memory",
                                  "no_card_memory", "fits"])
def test_intermediate_route_follows_device_shape_and_memory(case,
                                                            monkeypatch):
    """The card route for the intermediate grids is taken only on a CUDA
    device, for a grid, where the grids' page-locked buffers (each
    rounded up to a power of two) fit in the host memory available, and
    the card's free memory holds the (T, C) arrays, one grid and its
    variable's column in the grid's dtype: here a float32 series, whose
    flags' grids are float64."""
    from xmhw_tpu_torch import api

    da, _, ocean = box(20_215)
    ts = api.land_check(da)
    T, C = len(da.coords["time"].values), len(ocean)
    G = 6 * 8
    grids = [T * G * 4] * 10 + [T * G * 8] * 5
    host_need = api._pinned_bytes(grids)
    card_need = T * C * 45 + T * G * 8 + T * C * 8
    monkeypatch.setattr(api, "_host_available", lambda: host_need - (
        case == "no_host_memory"))
    monkeypatch.setattr(api, "_card_free", lambda dev: card_need - (
        case == "no_card_memory"))
    dev = {"cpu": torch.device("cpu"), "none": None}.get(
        case, torch.device("cuda"))
    if case == "point":
        ts = ts.isel(cell=0)
    assert api._inter_on_card(dev, case == "point", ts,
                              np.float32) == (case == "fits")


@pytest.mark.parametrize("case", ["derived", "given_nyears",
                                  "no_host_memory", "big_endian"])
@pytest.mark.parametrize("cell_block", [65536, 5], ids=["one", "blocks"])
def test_device_ranks_and_return_periods_are_the_host_path(
        answered, cell_block, case, monkeypatch):
    """mhw_rank's device path (the torch code, here on the CPU) gives the
    numpy host path's ranks and return periods bit for bit, in one cell
    block or in several, for float32 and float64 tables: with nYears
    derived from the data, with a non-integer nYears given (the return
    periods are numpy's ``(nYears + 1) / rank``), with no host memory
    available for page-locked buffers, and with big-endian tables (as a
    NetCDF file may hold them), which go up as float64. Each device call
    counts one ``rank_calls``; on the CPU none lands in page-locked
    memory."""
    from xmhw_tpu_torch import api

    dtype, *_, out = answered
    mhw = out[1]
    assert np.asarray(mhw["intensity_max"].data).dtype == dtype
    if case == "big_endian":
        mhw = _tables_as(mhw, np.dtype(dtype).newbyteorder(">"))
    kw = {"nYears": 14245 / 365.25} if case == "given_nyears" else {}
    if case == "no_host_memory":
        monkeypatch.setattr(api, "_host_available", lambda: 0)
    monkeypatch.setattr(utils, "_counts", {})
    rank_d, rp_d = xt.mhw_rank(mhw, device="cpu", cell_block=cell_block,
                               **kw)
    rank_h, rp_h = xt.mhw_rank(mhw, device=False, **kw)
    assert utils.counts() == {"rank_calls": 1}
    assert sorted(rank_d.keys()) == sorted(rank_h.keys())
    assert "intensity_max" in rank_d.keys()
    for k in rank_h.keys():
        for got, want in ((rank_d[k], rank_h[k]), (rp_d[k], rp_h[k])):
            assert got.dims == want.dims and got.data.dtype == np.float64
            np.testing.assert_array_equal(got.data, want.data, err_msg=k)
        if kw:
            np.testing.assert_array_equal(
                rp_d[k].data, (kw["nYears"] + 1) / rank_h[k].data, err_msg=k)


def _tables_as(mhw, dtype):
    """``mhw`` with every float table cast to ``dtype``."""
    from xmhw_tpu_torch.xrlite import Dataset

    ds = Dataset()
    for k in mhw.keys():
        a = np.asarray(mhw[k].data)
        ds[k] = mhw[k].copy(data=a.astype(dtype) if a.dtype.kind == "f"
                            else a)
    return ds


def _years_before(mhw):
    """mhw_rank's nYears as the port derived it before it skipped the
    year decode for datetime64 times: every entry's year decoded first."""
    from xmhw_tpu_torch.stats_api import _years_of

    try:
        y0, v0 = _years_of(mhw["time_start"].data, mhw["time_start"].attrs)
        y1, v1 = _years_of(mhw["time_end"].data, mhw["time_end"].attrs)
        t0 = np.asarray(mhw["time_start"].data).reshape(-1)
        t1 = np.asarray(mhw["time_end"].data).reshape(-1)
        if np.issubdtype(t0.dtype, np.datetime64):
            span = t1[~np.isnat(t1)].max() - t0[~np.isnat(t0)].min()
            return span / np.timedelta64(1, "D") / 365.25
        return float(y1[v1].max() - y0[v0].min() + 1)
    except Exception:
        return 14245 / 365.25


def _times_as(mhw, kind):
    """``mhw`` with its start and end times as datetime64 (as detect()
    gives them), as calendar years (numeric times without units), or
    all missing."""
    from xmhw_tpu_torch.xrlite import Dataset

    ds = Dataset()
    for k in mhw.keys():
        ds[k] = mhw[k]
    for k in ("time_start", "time_end"):
        t = np.asarray(mhw[k].data)
        if kind == "years":
            t = np.where(np.isnat(t), np.nan,
                         t.astype("datetime64[Y]").astype(np.int64) + 1970.0)
        elif kind == "missing":
            t = np.full(t.shape, np.datetime64("NaT"), t.dtype)
        ds[k] = mhw[k].copy(data=t)
    return ds


@pytest.mark.parametrize("kind", ["datetime64", "years", "missing"])
def test_derived_nyears_is_the_former_formula(answered, kind):
    """The derived nYears, which no longer decodes every entry's year for
    datetime64 times, is the same float as before in every branch, and
    the return periods on the device and on the host divide by it."""
    from xmhw_tpu_torch.stats_api import _record_years

    mhw = _times_as(answered[-1][1], kind)
    want = _years_before(mhw)
    assert _record_years(mhw) == want
    if kind == "datetime64":
        assert want != int(want) and want > 3
    for device in ("cpu", False):
        rank, rp = xt.mhw_rank(mhw, device=device)
        np.testing.assert_array_equal(
            rp["duration"].data, (want + 1) / np.asarray(rank["duration"].data))

