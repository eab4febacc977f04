"""CF-style metadata annotation for output datasets.

Replicates the provenance behavior of the reference (annotate_ds,
reference: xmhw/identify.py:539-696): units are inherited from the input
series (degree_C fallback), every output variable gets a long_name/units
pair, and global source/title/history attributes record how the dataset
was produced.
"""

from __future__ import annotations

from datetime import date

GITHUB = "https://github.com/coecms/xmhw"

# long_name/units templates for the mhw event variables
# (reference: identify.py:595-687); "{u}" is the inherited unit.
MHW_VAR_ATTRS = {
    "event": ("MHW event identifier: starting index", "1"),
    "duration": ("MHW duration in number of days", "1"),
    "intensity_max": (
        "MHW maximum (peak) intensity relative to seasonal climatology",
        "{u}"),
    "intensity_mean": (
        "MHW mean intensity relative to seasonal climatology", "{u}"),
    "intensity_var": (
        "MHW intensity variability relative to seasonal climatology", "{u}"),
    "intensity_cumulative": (
        "MHW cumulative intensity relative to seasonal climatology",
        "{u} day"),
    "severity_max": (
        "MHW maximum (peak) severity relative to seasonal climatology",
        "{u}"),
    "severity_mean": (
        "MHW mean severity relative to seasonal climatology", "{u}"),
    "severity_var": (
        "MHW severity variability relative to seasonal climatology", "{u}"),
    "severity_cumulative": (
        "MHW cumulative severity relative to seasonal climatology",
        "{u} day"),
    "rate_onset": ("MHW onset rate", "{u} day-1"),
    "rate_decline": ("MHW decline rate", "{u} day-1"),
    "intensity_max_relThresh": (
        "MHW maximum (peak) intensity relative to threshold", "{u}"),
    "intensity_mean_relThresh": (
        "MHW mean intensity relative to threshold", "{u}"),
    "intensity_var_relThresh": (
        "MHW intensity variability relative to threshold", "{u}"),
    "intensity_cumulative_relThresh": (
        "MHW cumulative intensity relative to threshold", "{u} day"),
    "intensity_max_abs": (
        "MHW maximum (peak) intensity absolute magnitude", "{u}"),
    "intensity_mean_abs": ("MHW mean intensity absolute magnitude", "{u}"),
    "intensity_var_abs": (
        "MHW intensity variability abosulute magnitude", "{u}"),
    "intensity_cumulative_abs": (
        "MHW cumulative intensity absolute magnitude", "{u} day"),
    "category": (
        "MHW category based on peak intensity: 1: Moderate, 2: Strong, "
        "3: Severe or 4: Extreme", None),
    "duration_moderate": ("Number of days falling in category Moderate",
                          "1"),
    "duration_strong": ("Number of days falling in category Strong", "1"),
    "duration_severe": ("Number of days falling in category Severe", "1"),
    "duration_extreme": ("Number of days falling in category Extreme", "1"),
}


def _inherited_units(ds_attrs) -> str:
    try:
        uts = ds_attrs["ts"]["units"]
        if any(s in uts for s in ("Celsius", "celsius")):
            uts = "degree_C"
        return uts
    except Exception:
        return "degree_C"


def annotate_ds(ds, ds_attrs, kind):
    """Attach inherited coordinate attrs + variable/global metadata.

    kind: 'clim' or 'mhw' (reference: identify.py:539-589).
    """
    uts = _inherited_units(ds_attrs)
    for c, coord in ds.coords.items():
        if c == "doy":
            coord.attrs.update(units="1", long_name="Day of the year")
        elif c == "events":
            coord.attrs.update(
                units="1", long_name="MHW event identifier: starting index")
        elif c == "point":
            continue
        elif c in ds_attrs:
            coord.attrs.update(ds_attrs[c])
    ds.attrs["source"] = f"xmhw code: {GITHUB}"
    if kind == "clim":
        ds.attrs["title"] = (
            "Seasonal climatology and threshold calculated to detect marine"
            " heatwaves following the  Hobday et al. (2016) definition"
        )
        for v in ("thresh", "seas"):
            if v in ds:
                ds[v].attrs["units"] = uts
    else:
        ds.attrs["title"] = (
            "Marine heatwave events identified applying the Hobday et al."
            " (2016) marine heat wave definition"
        )
        for name, (long_name, units) in MHW_VAR_ATTRS.items():
            if name not in ds:
                continue
            ds[name].attrs["long_name"] = long_name
            if units is not None:
                ds[name].attrs["units"] = units.format(u=uts)
    ds.attrs["history"] = (
        f"{date.today()}: calculated using xmhw code {GITHUB}")
    return ds


def threshold_params_attr(pctile, y0, y1, windowHalfWidth, skipna,
                          smoothPercentile, smoothPercentileWidth, anynans):
    """xmhw_parameters provenance string (reference: xmhw.py:221-246)."""
    params = (
        f"Threshold calculated using:\n    {pctile} percentile;\n"
        f"    climatology period is {y0}-{y1}';\n"
        f"    window half width used for percentile is {windowHalfWidth}"
    )
    if skipna:
        params += (";\n            NaNs where skipped in percentile "
                   "and mean calculations")
    if smoothPercentile:
        params += (
            ";\n         width of moving average window to smooth "
            f"percentile is\n         {smoothPercentileWidth}")
    if anynans:
        params += (
            ";\n            any grid point with even only 1 NaN along time"
            "\n            axis has been removed from calculation")
    return params


def detect_params_attr(minDuration, joinGaps, maxGap, coldSpells,
                       maxPadLength, anynans):
    """xmhw_parameters provenance string (reference: xmhw.py:487-515)."""
    params = f"MHW detected using: {minDuration} days of minimum duration"
    if joinGaps:
        params += (f";\n            events separated by {maxGap} or less "
                   "days were joined")
    if coldSpells:
        params += (";\n                cold events were detected instead "
                   "of heat events")
    if maxPadLength:
        params += (
            ";\n            where original timeseries had missing values "
            "interpolation\n            was used to fill them. Gaps > "
            f"{maxPadLength} days long were\n            left as NaNs;")
    if anynans:
        params += (
            ";\n            any grid point with even only 1 NaN along time"
            "\n            axis has been removed from calculation")
    return params
