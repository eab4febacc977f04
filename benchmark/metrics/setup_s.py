"""Seconds from the process's start to the window's: imports, loading the
kernel library (building it on a checkout's first run), making the
inputs and warming every shape the window runs (host clock)."""


def read(run):
    return run.setup_s
