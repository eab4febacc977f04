"""Share of the ranks' step walls spent waiting at the group's barrier:
the ranks' ``group_wait_ns`` (``parallel.barrier()``) over their
``group_step_ns`` (the entry's count of the same steps' walls), each
summed over the ranks' gathered counters (``run.rank_counts``). None
where the run holds no gathered counters or they count no step."""


def read(run):
    ranks = getattr(run, "rank_counts", None)
    if not ranks:
        return None
    step = sum(c.get("group_step_ns", 0) for c in ranks)
    if not step:
        return None
    return sum(c.get("group_wait_ns", 0) for c in ranks) / step
