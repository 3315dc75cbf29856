"""The DiT attention's share of its roofline: the least time the window's
attention work needs on the card (each self- and cross-attention call of
every DiT row the scheduler ran, its operations over the bf16 peak or its
bytes over the memory rate, whichever is larger; ``perfbench.flops``) over
the device time of the kernels that do that work in the trace."""
from perfbench import flops

#: the kernels that compute the DiT's attention
KERNELS = ("flash_sm90_kernel",)


def read(run):
    t = run.trace
    if t is None:
        return None
    spent = t.seconds_of(KERNELS)
    if spent <= 0:
        return None
    _, _, least = flops.attention_work(run.cell.config["model"])
    return 100.0 * run.window.stats["nfe"] * least / spent
