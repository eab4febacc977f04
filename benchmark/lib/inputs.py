"""The general generator of inputs: the time axis a configuration states,
and the series of its recipe, made from the run's seed.

A configuration's ``record`` gives the time axis and its ``recipe`` the
series; a traffic file gives how many cells, in what blocks. The same
seed gives the same inputs; a seed may be any non-negative integer that
fits in 63 bits.

* ``smoothed_seasonal`` (the repository's TPU benchmark, ``bench.py``):
  15 + 3 sin(2 pi day / 365.25) plus 2.5 times a 15-day circular running
  mean of unit normal noise, made on the device with a ``torch.Generator``.
* ``ersst_like``: an ERSST-v5-shaped field of (lat, lon) cells: a
  latitude-dependent base, a seasonal cycle of either hemisphere's
  phase, a linear trend of the configuration's ``trend_c_per_decade``
  and AR(1) monthly anomalies, ``land_share`` of the cells all NaN
  (chosen from the seed), made on the host with NumPy.
"""

from __future__ import annotations

import math

import numpy as np


def dates(record):
    """datetime64[ns] steps of a configuration's ``record``: daily from
    ``start`` to ``end``, or monthly on the 15th of each month."""
    if record["step"] == "day":
        return np.arange(record["start"], np.datetime64(record["end"])
                         + np.timedelta64(1, "D"),
                         dtype="datetime64[D]").astype("datetime64[ns]")
    if record["step"] == "month":
        y0, y1 = int(record["start"][:4]), int(record["end"][:4])
        return np.array([np.datetime64(f"{y:04d}-{m:02d}-15", "ns")
                         for y in range(y0, y1 + 1) for m in range(1, 13)])
    raise ValueError(f"unknown step {record['step']!r}")


def stream_seed(seed, k):
    """The seed of the k-th block of a run (for ``torch.Generator``)."""
    return (int(seed) * 1_000_003 + int(k)) % (1 << 63)


def smoothed_seasonal(T, C, seed, device):
    """(T, C) float32 on ``device``."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    day = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    base = 15 + 3 * torch.sin(2 * math.pi * day / 365.25)
    noise = torch.randn((T, C), generator=g, device=device)
    sm = sum(torch.roll(noise, k, 0) for k in range(-7, 8)) / 15.0
    return (base + 2.5 * sm).contiguous()


def ersst_like(dates_, lat, lon, seed, land_share, trend):
    """(T, len(lat), len(lon)) float32 on the host; ``trend`` in degrees
    a decade."""
    rng = np.random.default_rng(seed)
    T, n = len(dates_), len(lat) * len(lon)
    la = np.repeat(np.asarray(lat, np.float64), len(lon))
    m = np.arange(T)[:, None]
    x = np.empty((T, n))
    x[0] = rng.normal(0, 0.5, n)
    eps = rng.normal(0, 0.4, (T, n))
    for i in range(1, T):
        x[i] = 0.6 * x[i - 1] + eps[i]
    ts = (28 - 30 * (la / 90) ** 2 + trend * m / 120
          + 2.5 * np.sin(2 * np.pi * m / 12) * np.sign(la + 0.5) + x)
    ts = ts.astype(np.float32)
    ts[:, rng.permutation(n)[:int(land_share * n)]] = np.nan
    return ts.reshape(T, len(lat), len(lon))
