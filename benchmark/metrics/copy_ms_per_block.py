"""Device time of host-to-device and device-to-host copies, in ms per
cell block (the block driver's upload and fetch_rows)."""


def read(run):
    if run.trace is None or not run.traced_steps or not run.trace["ops"]:
        return None
    s = sum(sec for _, cat, _, sec, _ in run.trace["ops"]
            if cat == "gpu_memcpy")
    return 1e3 * s / run.blocks_traced()
