"""Operations and bytes the served work needs, from the configuration's
shapes (a multiply-add is two operations; each input byte read once and
each output byte written once).  Independent of how the program computes
it: the same count holds whatever kernel does the work."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Tuple

from perfbench.reference.model import TDIM, VAE_CHANNELS

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def peaks(kind: str) -> Mapping[str, float]:
    """The card's dense bf16 FLOP/s and memory bytes/s (``peaks.json``;
    a card it does not list reads as the H100 SXM)."""
    return PEAKS["cards"].get(kind, PEAKS["cards"][PEAKS["default"]])


def _dims(m: Mapping):
    d = m["d_model"]
    A = m["n_heads"] * (m["head_dim"] or d // m["n_heads"])
    S = (m["latent_size"] // m["patch"]) ** 2
    p_in = m["patch"] ** 2 * m["latent_channels"]
    return d, A, S, p_in, m["cond_len"]


def dit_row_flops(m: Mapping) -> int:
    """One DiT forward of one latent row at the full latent: every matrix
    product, attention's two included."""
    d, A, S, p_in, Lc = _dims(m)
    per_layer = (2 * d * 6 * d                                   # adaLN
                 + 2 * S * d * 3 * A + 4 * S * S * A + 2 * S * A * d  # self
                 + 2 * S * d * A + 4 * Lc * d * A + 4 * S * Lc * A
                 + 2 * S * A * d                                 # cross
                 + 4 * S * d * m["d_ff"])                        # MLP
    return (2 * S * p_in * d + 2 * TDIM * d + 2 * d * d
            + 2 * Lc * m["cond_dim"] * d + m["n_layers"] * per_layer
            + 2 * d * 2 * d + 2 * S * d * p_in)


def attention_work(m: Mapping, act_bytes: int = 2) -> Tuple[int, int, float]:
    """One DiT row's attention calls, all layers: (operations, bytes,
    least seconds on the card's peaks), each call's least time the larger
    of its operations over the FLOP peak and its bytes over the memory
    rate (``peaks`` of the default card)."""
    d, A, S, _, Lc = _dims(m)
    pk = peaks(PEAKS["default"])
    calls = ((4 * S * S * A, 4 * S * A * act_bytes),           # self
             (4 * S * Lc * A, (2 * S * A + 2 * Lc * A) * act_bytes))  # cross
    ops = sum(f for f, _ in calls) * m["n_layers"]
    nbytes = sum(b for _, b in calls) * m["n_layers"]
    least = sum(max(f / pk["bf16_flops"], b / pk["hbm_bytes_per_s"])
                for f, b in calls) * m["n_layers"]
    return ops, nbytes, least


def text_prompt_flops(t: Mapping, length: int) -> int:
    """One prompt through the text tower: its products, causal attention's
    at half the square."""
    d, L = t["d_model"], length
    per_layer = 2 * L * d * 4 * d + 2 * L * L * d + 4 * L * d * t["d_ff"]
    return t["n_layers"] * per_layer


def vae_image_flops(latent: int, latent_channels: int) -> int:
    """One latent (latent x latent) decoded: the 1x1 conv in, then a 3x3
    conv after each 2x upsampling."""
    c = list(reversed(VAE_CHANNELS))
    hw = latent * latent
    total = 2 * hw * latent_channels * c[0]
    for i in range(len(c) - 1):
        hw *= 4
        total += 2 * hw * 9 * c[i] * c[i + 1]
    hw *= 4
    return total + 2 * hw * 9 * c[-1] * 3
