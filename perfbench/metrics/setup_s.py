"""Seconds from the process's start to the window's: imports, the CUDA
context, weights from the seed, and the warm-up that captures every graph
the window replays (and, on a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
