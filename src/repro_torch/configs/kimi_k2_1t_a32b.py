"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8.  [arXiv:2501.kimi2]

Assignment specifies GQA kv=8 (the public K2 uses MLA; MLA is exercised by
deepseek-v2-lite here — see DESIGN.md §6).  First layer dense (d_ff 18432),
one shared expert, 384 routed top-8.
"""
from repro_torch.config import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=18432, vocab=163840, head_dim=128,
        mlp_kind="swiglu", rope_theta=5e4,
        moe=MoEConfig(n_routed=384, top_k=8, d_ff_expert=2048,
                      n_shared=1, first_moe_layer=1, d_ff_dense=18432),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64,
        mlp_kind="swiglu",
        moe=MoEConfig(n_routed=4, top_k=2, d_ff_expert=128,
                      n_shared=1, first_moe_layer=1, d_ff_dense=512),
    )


register("kimi-k2-1t-a32b", full, smoke)
