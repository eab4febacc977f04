"""``region_ms_per_call.land_check``: see region_ms_per_call.py."""

from benchmark.lib import spec

read = spec.module("metrics", "region_ms_per_call").reader("land_check")
