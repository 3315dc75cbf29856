"""The benchmark's operation and byte counts against what PyTorch's
FlopCounterMode counts of the port's own modules at smoke width."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops
from perfbench.tests import smoke


def _dit(m, **over):
    from repro_torch.config import ModelConfig
    from repro_torch.models.dit import DiT
    cfg = ModelConfig(**{**m, "attn_impl": "naive", "dtype": "float32",
                         **over})
    return cfg, DiT(cfg, device="cpu")


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    by_op = {str(k).rsplit(".", 1)[-1]: v
             for k, v in fc.get_flop_counts()["Global"].items()}
    return fc.get_total_flops(), by_op


@pytest.mark.parametrize("B", [1, 3])
def test_dit_row_flops_equal_the_counter(B):
    m = smoke.config()["model"]
    cfg, dit = _dit(m)
    S = m["latent_size"]
    z = torch.randn(B, S, S, m["latent_channels"])
    t = torch.randint(0, 1000, (B,))
    c = torch.randn(B, m["cond_len"], m["cond_dim"])
    total, _ = _counted(lambda: dit(z, t, c))
    assert total == B * flops.dit_row_flops(m)


def test_dit_row_flops_follow_the_head_width():
    m = {**smoke.config()["model"], "head_dim": 24}
    cfg, dit = _dit(m)
    S = m["latent_size"]
    total, _ = _counted(lambda: dit(
        torch.randn(2, S, S, 4), torch.tensor([3, 900]),
        torch.randn(2, m["cond_len"], m["cond_dim"])))
    assert total == 2 * flops.dit_row_flops(m)


def test_attention_work_counts_the_calls_the_dit_makes(monkeypatch):
    """Operations: the counter's batched products, which in the naive
    route are attention's two alone; bytes: q, k, v and the output of
    every ``dispatch.attention`` call at 2 bytes an element."""
    from repro_torch.kernels import dispatch
    m = smoke.config()["model"]
    cfg, dit = _dit(m)
    seen = []
    real = dispatch.attention

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append(q.numel() + k.numel() + v.numel() + out.numel())
        return out
    monkeypatch.setattr(dispatch, "attention", spy)
    S = m["latent_size"]
    _, by_op = _counted(lambda: dit(
        torch.randn(1, S, S, 4), torch.tensor([500]),
        torch.randn(1, m["cond_len"], m["cond_dim"])))
    ops, nbytes, least = flops.attention_work(m)
    assert by_op["bmm"] == ops
    assert 2 * sum(seen) == nbytes
    pk = flops.peaks("")
    assert least >= (1 - 1e-12) * max(ops / pk["bf16_flops"],
                                      nbytes / pk["hbm_bytes_per_s"])


def test_text_and_vae_counts():
    from repro_torch.config import ModelConfig
    from repro_torch.models.text_encoder import TextTower
    from repro_torch.models.vae import VAEDecoder
    cfg = smoke.config()
    t = cfg["text"]
    L = cfg["model"]["cond_len"]
    tower = TextTower(ModelConfig(name="t", family="dense",
                                  n_kv_heads=t["n_heads"],
                                  **{**t, "attn_impl": "naive"}),
                      device="cpu")
    total, by_op = _counted(lambda: tower(torch.randint(0, 258, (1, L))))
    # the counter charges the causal scores at the full square
    assert total - by_op["bmm"] // 2 == flops.text_prompt_flops(t, L)
    vae = VAEDecoder(device="cpu")
    total, _ = _counted(lambda: vae(torch.randn(2, 8, 8, 4)))
    assert total == 2 * flops.vae_image_flops(8, 4)
