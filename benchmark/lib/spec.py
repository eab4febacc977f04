"""The benchmark's data, found by name: BENCHMARK.json at the root of the
checkout, and under ``benchmark/`` a file of its own for each
configuration (``configs/``), traffic mix (``workloads/``), entry
(``entries/``), metric reader (``metrics/``), kernel's work count
(``kernels/``) and cell's limits (``limits/``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent   # benchmark/
ROOT = HERE.parent                              # the checkout


def _json(path):
    with open(path) as f:
        return json.load(f)


def bench():
    return _json(ROOT / "BENCHMARK.json")


def cell(name, b=None):
    """The ``workloads`` entry of cell ``name``."""
    b = b or bench()
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name, b=None):
    """The configuration file of configuration ``name``."""
    b = b or bench()
    for c in b["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name):
    return _json(HERE / "workloads" / f"{name}.json")


def limits(cell_name):
    return _json(HERE / "limits" / f"{cell_name}.json")


def module(kind, name):
    """The module ``benchmark/<kind>/<name>.py`` (a name may hold dots);
    for a name ``<base>.<part>`` without a file of its own, the module
    of ``<base>``, which then reads every such name."""
    path = HERE / kind / f"{name}.py"
    while not path.exists() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell_name, kind, b=None):
    """The ``end_to_end`` or ``per_layer`` entries that cell ``cell_name``
    reports: those that list it, and those without a ``workloads`` key."""
    b = b or bench()
    return [m for m in b[kind]
            if cell_name in m.get("workloads", [cell_name])]
