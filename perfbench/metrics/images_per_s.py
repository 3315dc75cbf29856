"""Images served per second: every batch begun inside the window is
finished, and its served images are divided by the time from the window's
start to the end of the last of them.  A failed image does not count."""
from perfbench.harness import served


def read(run):
    w = run.window
    if w.t_last <= w.t0:
        return None
    return sum(served(r) for r in w.requests) / (w.t_last - w.t0)
