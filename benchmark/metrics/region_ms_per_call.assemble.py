"""``region_ms_per_call.assemble``: see region_ms_per_call.py."""

from benchmark.lib import spec

read = spec.module("metrics", "region_ms_per_call").reader("assemble")
