"""``workflow_ms_per_call.assemble_inter``: the benchmark's span around
``api._assemble_inter`` (the intermediate Dataset's grids), in ms per
step; see region_ms_per_call.py."""

from benchmark.lib import spec

read = spec.module("metrics", "region_ms_per_call").reader("assemble_inter")
