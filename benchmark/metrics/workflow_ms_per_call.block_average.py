"""``workflow_ms_per_call.block_average``: the benchmark's span around
``stats_api.block_average``, in ms per step; see region_ms_per_call.py."""

from benchmark.lib import spec

read = spec.module("metrics", "region_ms_per_call").reader("block_average")
