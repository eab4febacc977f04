"""The public options of threshold() and detect(), port against xmhw_tpu.

The options are chip_smoke.OPTIONS, which chip_smoke.py's ``options``
phase runs through the kernels on the card against the plain versions.
Here each runs on the CPU, from the same numpy inputs, through the port
(device="cpu") and through the JAX package, on a small grid: 34 daily
years, 2 x 3 cells with one of land (the "gaps" grid adds NaN gaps to
the ocean cells; "noleap" and "360_day" put 30 years of its values on
those calendars), and on ERSST v5's monthly record (1854-2024, tstep).
detect() takes the JAX package's climatology in both packages, so that
the events of the two are those of one threshold.

Bars: float64 climatology rtol = atol = 1e-12 and event floats rtol 1e-9,
atol 1e-12; float32 thresh atol 1e-6, seas atol 1e-5, event floats
rtol = atol = 2e-3 (tests/test_pallas.py's bars between the JAX
package's own engines). Counts, positions, times and categories exact.

A second test rehearses the options phase itself on the CPU: the port's
kernel route (range tables; on the CPU the kernels' plain versions)
against its plain route (the gather path), through chip_smoke's own
comparison, at the card's bars.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu as xm  # noqa: E402
import xmhw_tpu_torch as xt  # noqa: E402
from test_torch_api import EXACT, same_ds  # noqa: E402
from xmhw_tpu.xrlite import Coord as JCoord  # noqa: E402
from xmhw_tpu.xrlite import DataArray as JDataArray  # noqa: E402
from xmhw_tpu.xrlite import TimeIndex as JTimeIndex  # noqa: E402
from xmhw_tpu_torch.core import pipeline  # noqa: E402
from xmhw_tpu_torch.xrlite import TimeIndex  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

CASES = sorted(cs.OPTIONS) + ["ersst_v5_monthly"]
CLIM_TOL = {np.float64: dict(thresh=1e-12, seas=1e-12),
            np.float32: dict(thresh=1e-6, seas=1e-5)}  # rtol = atol


def to_jax(da):
    """A port DataArray as the JAX package's, on the same numpy data."""
    coords = {}
    for k, c in da.coords.items():
        v = c.values
        if isinstance(v, TimeIndex):
            v = JTimeIndex(np.asarray(v.values), calendar=v.calendar,
                           units=v.units)
        coords[k] = JCoord(c.dims, v, dict(c.attrs))
    return JDataArray(np.asarray(da.data), da.dims, coords, dict(da.attrs))


@pytest.fixture(scope="module")
def grids():
    da = cs.grid(cs.daily("1988-01-01", "2022-01-01"), 2, 3, seed=5, land=1)
    out = cs.option_grids(da, years=30)
    out["ersst_v5_monthly"] = cs.ersst_grid().isel(lat=slice(44, 46),
                                                   lon=slice(0, 4))
    return out


def case_of(name):
    if name == "ersst_v5_monthly":
        rec = cs.LONG_RECORDS[name]
        return name, rec["thr"], rec["det"]
    return cs.OPTIONS[name]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", CASES)
def test_option_matches_jax(grids, name, dtype):
    data, thr_kw, det_kw = case_of(name)
    da = grids[data]
    ja = to_jax(da)
    det_kw = {"events_layout": "compact", **det_kw}
    a = xm.threshold(ja, dtype=dtype, **thr_kw)
    b = xt.threshold(da, dtype=dtype, device="cpu", **thr_kw)
    tol = CLIM_TOL[dtype]
    same_ds(a, b, rtol=tol["seas"], atol=tol["seas"])
    np.testing.assert_allclose(b["thresh"].data, a["thresh"].data,
                               rtol=tol["thresh"], atol=tol["thresh"],
                               equal_nan=True)
    ma = xm.detect(ja, a["thresh"], a["seas"], dtype=dtype, **det_kw)
    mb = xt.detect(da, a["thresh"], a["seas"], dtype=dtype, device="cpu",
                   **det_kw)
    ma, mb = (m if isinstance(m, tuple) else (m,) for m in (ma, mb))
    assert len(ma) == len(mb) == (2 if det_kw.get("intermediate") else 1)
    tol = dict(rtol=1e-9, atol=1e-12) if dtype == np.float64 else dict(
        rtol=2e-3, atol=2e-3)
    for x, y in zip(ma, mb):
        same_ds(x, y, exact=EXACT, **tol)
    n = np.isfinite(np.asarray(mb[0]["duration"].data)).sum()
    assert n > (5 if data != "ersst_v5_monthly" else 20), n


@pytest.mark.parametrize("name", sorted(cs.OPTIONS))
def test_options_phase_on_the_cpu(grids, name, monkeypatch):
    """chip_smoke.option_pair as the options phase runs it, on the CPU:
    the kernel route (on the CPU: the kernels' plain versions over range
    tables) on the whole grid against the plain route (the gather path)
    on its first lat row, at the card's bars."""
    data, thr_kw, det_kw = cs.OPTIONS[name]
    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "read_launches", lambda: {"cpu": 1})
    monkeypatch.setattr(pipeline, "use_kernels_for",
                        lambda dtype, dev, override=None: True)
    wall, launches, n, errs = cs.option_pair(grids[data], thr_kw, det_kw,
                                             name, lats=1)
    assert n > 0 and errs[0] <= cs.TOL["seas"]
    # the plain run's route is undone on leaving it
    assert pipeline.use_kernels_for(np.float32, torch.device("cpu"))
