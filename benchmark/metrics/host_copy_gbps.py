"""The host's copy rate, in GB/s (1e9 bytes a second): the bytes the
block driver copies up and down (``h2d_bytes`` + ``d2h_bytes``) over the
host wall of those copies alone (``h2d_ns`` + ``d2h_ns``; the program's
``utils.copy_wall`` waits for the work queued on the card before it
starts the clock, so no kernel's time is in it), from the processes'
start: the set-up's warm-up makes the window's copies too. Summed over
the ranks where the run holds every rank's counters
(``run.rank_counts``), else this process's counters. A program without
the wall counters reads None."""

from benchmark.lib import counts


def read(run):
    ranks = getattr(run, "rank_counts", None) or [counts.program() or {}]
    ns = sum(c.get("h2d_ns", 0) + c.get("d2h_ns", 0) for c in ranks)
    if not ns:
        return None
    return sum(c.get("h2d_bytes", 0) + c.get("d2h_bytes", 0)
               for c in ranks) / ns
