"""Card 0's idle share of the traced stretch, in %: 1 - the union of the
device operations on the run's first card over the stretch. The
harness's process traces only the card it drives, so this reads that
card alone and is not averaged over the cell's cards (as
``device_idle_share`` is)."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace["busy_s"].get(str(run.devices[0].index or 0))
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / run.trace["window_s"])
