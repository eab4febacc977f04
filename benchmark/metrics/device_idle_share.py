"""Share of the traced stretch in which no kernel, copy or set ran on the
card (1 - the union of device operations over the stretch), in %,
averaged over the cards used. Reads every ``device_idle_share.<cells>``
metric: one name for each end-to-end metric that it moves."""


def read(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    busy = sum(run.trace["busy_s"].values()) / len(run.devices)
    return 100.0 * (1.0 - busy / run.trace["window_s"])
