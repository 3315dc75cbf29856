"""The whole served step's share of the card's dense bf16 peak over the
traced window: the benchmark's own count of the work the window's batches
needed (every DiT row the scheduler ran, pad rows left out; the text tower
a prompt; the VAE decoder an image; ``perfbench.flops``) over the window's
seconds times the peak."""
from perfbench import flops


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    cfg, s = run.cell.config, run.window.stats
    m = cfg["model"]
    work = (s["nfe"] * flops.dit_row_flops(m)
            + len(run.window.requests) * flops.text_prompt_flops(
                cfg["text"], m["cond_len"])
            + s["completed"] * flops.vae_image_flops(m["latent_size"],
                                                     m["latent_channels"]))
    return 100.0 * work / (t.window_s * flops.peaks(run.device_kind)
                           ["bf16_flops"])
