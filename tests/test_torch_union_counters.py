"""The union assembly's counters and spans, on the host route and on the
card route (forced, on CPU tensors, as in test_torch_union.py).

``union_rows`` sums the events rows of each union assembly, on either
route and for a point series too; ``union_pinned_bytes`` sums, where the
card route runs, the page-locked bytes its grids ask of the caching host
allocator (each grid rounded up to a power of two). Under a profiler the
assembly holds the spans ``xmhw/union_geometry`` and, on a grid,
``xmhw/union_grids``. Imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu_torch as xt  # noqa: E402
from test_torch_union import field, grid  # noqa: E402
from test_torch_utils import _inside, _spans  # noqa: E402
from xmhw_tpu_torch import api, utils  # noqa: E402

MiB = 1 << 20


def _delta(before):
    after = utils.counts()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _grid_bytes(mhw):
    return [np.asarray(mhw[k].data).nbytes for k in mhw.keys()
            if "events" in mhw[k].dims]


@pytest.mark.parametrize("route", ["host", "card"])
def test_counters_on_each_route(route, monkeypatch):
    da = grid(field())
    clim = xt.threshold(da, device="cpu")
    if route == "card":
        monkeypatch.setattr(api, "_union_on_card", lambda dev, nbytes: True)
    before = utils.counts()
    mhw = xt.detect(da, clim["thresh"], clim["seas"], device="cpu")
    got = _delta(before)
    E = mhw["event"].shape[0]
    assert E > 0
    assert got["union_calls"] == 1 and got["union_rows"] == E
    if route == "host":
        assert "union_pinned_bytes" not in got
        assert "union_card_calls" not in got
        return
    grid_bytes = _grid_bytes(mhw)
    assert got["union_card_bytes"] == sum(grid_bytes)
    assert got["union_pinned_bytes"] == api._pinned_bytes(grid_bytes)
    assert sum(grid_bytes) <= got["union_pinned_bytes"] < 2 * sum(
        grid_bytes)


def test_union_rows_counts_a_point_series_and_an_empty_union():
    da = grid(field())
    p = da.isel(lat=2, lon=3)
    clim = xt.threshold(p, device="cpu")
    before = utils.counts()
    mhw = xt.detect(p, clim["thresh"], clim["seas"], device="cpu")
    assert _delta(before)["union_rows"] == mhw["event"].shape[0] > 0
    calm = grid(np.where(np.isnan(field()), np.nan, 15.0))
    clim = xt.threshold(calm, device="cpu")
    before = utils.counts()
    xt.detect(calm, clim["thresh"], clim["seas"], device="cpu")
    got = _delta(before)
    assert got["union_calls"] == 1 and "union_rows" not in got


def test_pinned_bytes_round_each_grid_up_to_a_power_of_two():
    assert api._pinned_bytes([]) == 0
    assert api._pinned_bytes([1, MiB, 0]) == 1 + MiB
    assert api._pinned_bytes([MiB + 1, 3 * MiB]) == 2 * MiB + 4 * MiB
    # the route's test asks for exactly these bytes
    assert api._union_on_card("cuda", [MiB + 1]) == (
        2 * MiB <= api._host_available())


@pytest.mark.parametrize("route", ["host", "card"])
def test_spans_of_the_assembly(route, monkeypatch, tmp_path):
    da = grid(field())
    clim = xt.threshold(da, device="cpu")
    if route == "card":
        monkeypatch.setattr(api, "_union_on_card", lambda dev, nbytes: True)
    with utils.trace(str(tmp_path)):
        xt.detect(da, clim["thresh"], clim["seas"], device="cpu")
    sp = _spans(tmp_path)
    names = [n for _, _, n in sp]
    assert names.count("union_geometry") == 1
    assert names.count("union_grids") == 1
    for inner in ("union_geometry", "union_grids"):
        assert _inside(sp, inner, "assemble"), inner
    (g0, g1), = [(a, b) for a, b, n in sp if n == "union_geometry"]
    (u0, u1), = [(a, b) for a, b, n in sp if n == "union_grids"]
    assert g1 <= u0


def test_point_series_has_no_grids_span(tmp_path):
    p = grid(field()).isel(lat=2, lon=3)
    clim = xt.threshold(p, device="cpu")
    with utils.trace(str(tmp_path)):
        xt.detect(p, clim["thresh"], clim["seas"], device="cpu")
    names = [n for _, _, n in _spans(tmp_path)]
    assert names.count("union_geometry") == 1
    assert "union_grids" not in names
