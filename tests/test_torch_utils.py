"""The port's observability helpers (xmhw_tpu_torch.utils): timed() and
trace(), the counterparts of xmhw_tpu.utils. Their CUDA side (timed()
synchronising the card) is tested in tests/test_torch_cuda.py."""

import json
import logging

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xmhw_tpu_torch import utils  # noqa: E402


def test_timed_measures_and_leaves_cpu_tensors_alone(monkeypatch, caplog):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    with caplog.at_level(logging.INFO, logger="xmhw_tpu_torch"):
        with utils.timed("sum", sync=torch.ones(3)) as t:
            t["sync"] = {"a": [torch.zeros(2), (torch.ones(1), 3)]}
    assert t["seconds"] >= 0.0
    assert calls == []  # nothing on a CUDA device: no synchronisation
    assert "sum:" in caplog.text
    with utils.timed("quiet", log=False) as t:
        pass
    assert t["seconds"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with utils.trace(str(tmp_path / "tr")) as prof:
        (torch.arange(1000.0) * 2).sum()
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0


# --- spans and counters -------------------------------------------------

import glob  # noqa: E402

import numpy as np  # noqa: E402

from xmhw_tpu_torch import detect, threshold  # noqa: E402
from xmhw_tpu_torch.core import pipeline  # noqa: E402
from xmhw_tpu_torch.xrlite import Coord, DataArray  # noqa: E402


def _spans(logdir):
    """(start, end, name without 'xmhw/') of every program span in the
    one chrome trace written into ``logdir``, in start order."""
    (path,) = glob.glob(str(logdir / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"][len(utils.SPAN_PREFIX):]) for e in events
                  if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith(utils.SPAN_PREFIX))


def _inside(spans, inner, *outer):
    """Every ``inner`` span lies inside a span named in ``outer``."""
    outs = [(a, b) for a, b, n in spans if n in outer]
    return all(any(a0 <= a and b <= b0 for a0, b0 in outs)
               for a, b, n in spans if n == inner)


def _grid(years=3, shape=(3, 4), seed=0):
    t = np.arange(f"{1990}-01-01", f"{1990 + years}-01-01",
                  dtype="datetime64[D]")
    rng = np.random.default_rng(seed)
    x = (15 + 3 * np.sin(2 * np.pi * np.arange(len(t)) / 365.25)[
        :, None, None] + rng.normal(0, 1, (len(t),) + shape)).astype(
        np.float32)
    x[:, 0, 0] = np.nan  # one land cell
    return DataArray(x, ("time", "lat", "lon"),
                     {"time": Coord(("time",), t),
                      "lat": Coord(("lat",), np.arange(float(shape[0]))),
                      "lon": Coord(("lon",), np.arange(float(shape[1])))})


def _delta(before):
    after = utils.counts()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    _no_record_function(monkeypatch)
    assert utils.span("a") is utils.span("b")
    with utils.span("upload") as s:
        assert s is None
    # the decorated stages run with no profiler and call nothing of it
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    got = pipeline.fetch_rows({"x": pipeline.upload(x, 1, 3, "cpu",
                                                    pad_rows=2)})
    assert got["x"].shape == (8, 2)
    np.testing.assert_array_equal(got["x"][:6], x[:, 1:3])


def test_in_span_keeps_the_function_and_opens_its_span(tmp_path):
    import inspect

    @utils.in_span("probe")
    def probe(a, b=2):
        """Doc."""
        return a + b

    assert probe.__name__ == "probe" and probe.__doc__ == "Doc."
    assert list(inspect.signature(probe).parameters) == ["a", "b"]
    assert list(inspect.signature(pipeline.run_fused).parameters)[:3] == [
        "ts_np", "doy_np", "doy_pos_np"]
    with utils.trace(str(tmp_path)):
        assert probe(1) == 3
    assert [n for _, _, n in _spans(tmp_path)] == ["probe"]


def test_threshold_and_detect_emit_their_spans_nested(tmp_path):
    da = _grid()
    with utils.trace(str(tmp_path)):
        clim = threshold(da, device="cpu")
        detect(da, clim["thresh"], clim["seas"], device="cpu")
    sp = _spans(tmp_path)
    names = [n for _, _, n in sp]
    want = {"threshold": 1, "detect": 1, "land_check": 4, "assemble": 2,
            "align_clim": 2, "run_clim": 1, "run_detect": 1,
            "clim_tables": 1, "count_k": 1, "detect_retry": 1, "store": 1}
    assert {k: names.count(k) for k in want} == want
    assert names.count("upload") == 4 and names.count("fetch_rows") == 2
    for inner in ("land_check", "assemble"):
        assert _inside(sp, inner, "threshold", "detect"), inner
    assert _inside(sp, "run_clim", "threshold")
    for inner in ("run_detect", "align_clim"):
        assert _inside(sp, inner, "detect"), inner
    for inner in ("upload", "fetch_rows", "clim_tables"):
        assert _inside(sp, inner, "run_clim", "run_detect"), inner
    for inner in ("count_k", "detect_retry", "store"):
        assert _inside(sp, inner, "run_detect"), inner
    # threshold's first land_check lies in threshold, the other three in
    # detect
    lc = [(a, b) for a, b, n in sp if n == "land_check"]
    (t0, t1), (d0, d1) = [(a, b) for a, b, n in sp
                          if n in ("threshold", "detect")]
    assert t0 <= lc[0][0] and lc[0][1] <= t1
    assert all(d0 <= a and b <= d1 for a, b in lc[1:])


def _stats_block(years=3, cells=24, seed=1):
    t = np.arange(f"{1990}-01-01", f"{1990 + years}-01-01",
                  dtype="datetime64[D]")
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.xrlite import TimeIndex

    doy, ndoy = compute_doy(TimeIndex(t), keep_tstep=False)
    rng = np.random.default_rng(seed)
    x = (15 + 3 * np.sin(2 * np.pi * np.arange(len(t)) / 365.25)[:, None]
         + rng.normal(0, 1, (len(t), cells))).astype(np.float32)
    yr = t.astype("datetime64[Y]").astype(np.int64) + 1970
    ybod = (yr - yr[0]).astype(np.int32)
    edges = tuple(int(v) for v in np.searchsorted(
        yr, np.arange(yr[0], yr[-1] + 2), side="left"))
    return x, doy, dict(ndoy=ndoy, ybod_np=ybod, nbins=years,
                        day_edges=edges, device="cpu")


def test_run_fused_emits_its_spans_nested(tmp_path):
    x, doy, kw = _stats_block()
    with utils.trace(str(tmp_path)):
        pipeline.run_fused(x, doy, doy - 1, **kw)
    sp = _spans(tmp_path)
    names = [n for _, _, n in sp]
    assert names.count("run_fused") == 1
    for inner, n in (("clim_tables", 1), ("upload", 1), ("count_k", 1),
                     ("detect_retry", 1), ("fused_stats", 1),
                     ("fetch_rows", 1), ("store", 2)):
        assert names.count(inner) == n, inner
        assert _inside(sp, inner, "run_fused"), inner
    assert not {"threshold", "detect", "land_check"} & set(names)


def test_fused_threshold_detect_emits_its_span(tmp_path):
    x, doy, kw = _stats_block()
    with utils.trace(str(tmp_path)):
        pipeline.fused_threshold_detect(torch.from_numpy(x), doy, doy - 1,
                                        ndoy=kw["ndoy"], K=64)
    sp = _spans(tmp_path)
    assert [n for _, _, n in sp] == ["fused_threshold_detect",
                                     "clim_tables"]
    assert _inside(sp, "clim_tables", "fused_threshold_detect")


def test_byte_counters_count_the_uploads_and_fetches():
    x = np.arange(60, dtype=np.float32).reshape(10, 6)
    before = utils.counts()
    t = pipeline.upload(x, 2, 5, "cpu", pad_rows=3)
    assert _delta(before) == {"h2d_bytes": x[:, 2:5].nbytes}
    d = {"a": t, "b": torch.arange(7), "c": torch.ones(2, 3)}
    before = utils.counts()
    pipeline.fetch_rows(d)
    assert _delta(before) == {"d2h_bytes": sum(v.nbytes
                                               for v in d.values())}


def test_run_detect_counts_its_bytes_passes_and_blocks():
    x, doy, kw = _stats_block(cells=8)
    th, se = pipeline.run_clim(x, doy, 5, kw["ndoy"], 90, True, 31, True,
                               device="cpu")
    pos = (doy - 1).astype(np.int32)
    before = utils.counts()
    tables, nev, inter = pipeline.run_detect(x, th, se, pos, 5, True, 2,
                                             device="cpu")
    got = _delta(before)
    # three series up and the doy rows once; one fetch of the tables and
    # counts; a counting pass and a detection on the one block
    assert got["h2d_bytes"] == x.nbytes + th.nbytes + se.nbytes + pos.nbytes
    assert got["d2h_bytes"] == (sum(v.nbytes for v in tables.values())
                                + nev.nbytes)
    assert (got["detect_passes"], got["detect_blocks"]) == (2, 1)
    # two blocks: the counting pass on the first only
    before = utils.counts()
    pipeline.run_detect(x, th, se, pos, 5, True, 2, block=4, device="cpu")
    got = _delta(before)
    assert (got["detect_passes"], got["detect_blocks"]) == (3, 2)


def test_a_rerun_counts_a_detect_pass():
    # six warm days, four cool ones: ~109 events a cell in 1,095 days,
    # more than a first K of 32, so the block reruns at 128
    t = 1095
    ts = np.where(np.arange(t) % 10 < 6, 1.0, -1.0).astype(np.float32)
    ts = np.repeat(ts[:, None], 3, axis=1)
    th = np.zeros((366, 3), np.float32)
    pos = (np.arange(t) % 365).astype(np.int32)
    before = utils.counts()
    tables, nev, _ = pipeline.run_detect(ts, th, th, pos, 5, True, 2,
                                         first_k=1, device="cpu")
    assert nev.max() > 32 and tables["event"].shape[0] == 128
    got = _delta(before)
    assert (got["detect_passes"], got["detect_blocks"]) == (2, 1)


def test_trace_waits_for_every_visible_card(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    with utils.trace(str(tmp_path)):
        torch.ones(3).sum()
    assert calls == [0, 1, 2]
