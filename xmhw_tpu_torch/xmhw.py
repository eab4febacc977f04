"""Reference-style import path: ``from xmhw_tpu_torch.xmhw import threshold,
detect`` mirrors the reference's ``from xmhw.xmhw import threshold,
detect`` (reference: docs/gettingstarted.rst:19)."""

from .api import detect, land_check, threshold  # noqa: F401
from .exception import XmhwException  # noqa: F401

__all__ = ["threshold", "detect", "land_check", "XmhwException"]


def calc_clim(ts, tdim="time", pctile=90, windowHalfWidth=5,
              smoothPercentile=True, smoothPercentileWidth=31,
              tstep=False, skipna=False, dtype=None, device="cuda"):
    """Climatology for a single timeseries (reference: xmhw.py:250-307).

    ts: 1-D DataArray with a time coordinate. Returns (thresh, seas)
    DataArrays on the 'doy' dimension. ``device``: where it runs
    (default ``"cuda"``), as in threshold().
    """
    import numpy as np

    from .api import _time_index
    from .core.calendar import compute_doy
    from .core.pipeline import run_clim
    from .xrlite import Coord, DataArray

    tindex = _time_index(ts, tdim)
    doy, ndoy = compute_doy(tindex, keep_tstep=tstep)
    data = np.asarray(ts.data, dtype=dtype or np.float64)
    if data.ndim == 1:
        data = data[:, None]
    th, se = run_clim(data, doy, windowHalfWidth, ndoy, pctile=pctile,
                      smooth=smoothPercentile,
                      smooth_w=smoothPercentileWidth,
                      patch_feb29=not tstep, device=device)
    doy_coord = Coord(("doy",), np.arange(1, ndoy + 1))
    return (DataArray(th[:, 0], ("doy",), {"doy": doy_coord},
                      name="thresh"),
            DataArray(se[:, 0], ("doy",), {"doy": doy_coord},
                      name="seas"))
