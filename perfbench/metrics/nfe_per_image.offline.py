"""Denoiser rows the scheduler ran per served image over the window
(``stats["nfe"]`` over ``stats["completed"]``, pad rows not counted): what
shared sampling saves, at 2 x 30 = 60 without it."""


def read(run):
    s = run.window.stats
    return s["nfe"] / s["completed"] if s.get("completed") else None
