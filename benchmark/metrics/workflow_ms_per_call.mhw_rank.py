"""``workflow_ms_per_call.mhw_rank``: the benchmark's span around
``stats_api.mhw_rank``, in ms per step; see region_ms_per_call.py."""

from benchmark.lib import spec

read = spec.module("metrics", "region_ms_per_call").reader("mhw_rank")
