"""Ocean cells the cell's steps completed, over the whole window (host
clock; the window ends when every card has finished the last step
issued before the deadline)."""


def read(run):
    return run.cells / run.window_s
