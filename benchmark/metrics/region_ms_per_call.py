"""Host walls of a threshold() + detect() pair by stage, in ms per step,
from the benchmark's spans that ``entries/api_region.py`` puts around
the API's functions: ``region_ms_per_call.<part>``, where ``land_check``
is the four land checks of a pair, ``assemble`` the union assembly
(``api._assemble_events``) and ``host`` the step less the spans around
``run_clim`` and ``run_detect``, as ``api_host_ms_per_call`` reckons it.
Each name has a file of its own that takes its reader from here; the
bare name reads the whole step."""

from benchmark.lib import spec


def span_ms(run, name):
    """The spans ``name`` of the traced steps, in ms per step; None
    without a trace or without such a span."""
    if run.trace is None:
        return None
    sp = run.trace["spans"]
    steps = sp.get("step", [])
    if not steps or name not in sp:
        return None
    return 1e3 * sum(b - a for a, b in sp[name]) / len(steps)


def reader(part):
    """The reader of ``region_ms_per_call.<part>``."""
    if part == "host":
        return spec.module("metrics", "api_host_ms_per_call").read
    return lambda run: span_ms(run, part)


read = reader("step")
