"""Host time of a threshold() + detect() pair outside the spans around
the run_clim and run_detect it calls (land_check, the union assembly,
xrlite), in ms per call, from the benchmark's spans."""


def read(run):
    if run.trace is None:
        return None
    sp = run.trace["spans"]
    steps = sp.get("step", [])
    if not steps:
        return None

    def total(name):
        return sum(b - a for a, b in sp.get(name, []))

    return 1e3 * (total("step") - total("run_clim")
                  - total("run_detect")) / len(steps)
