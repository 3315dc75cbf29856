"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff_expert=1408
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed top-6.  [arXiv:2405.04434]

The assignment line says both "MoE 64e" and "160 routed"; we follow the
published V2-Lite (64 routed, 2 shared, top-6) and note the discrepancy in
DESIGN.md §6.  First layer is dense with d_ff 10944.
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab=102400,
        attn_kind="mla", mlp_kind="swiglu",
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(n_routed=64, top_k=6, d_ff_expert=1408,
                      n_shared=2, first_moe_layer=1, d_ff_dense=10944),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512,
        attn_kind="mla", mlp_kind="swiglu",
        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32),
        moe=MoEConfig(n_routed=4, top_k=2, d_ff_expert=128,
                      n_shared=2, first_moe_layer=1, d_ff_dense=512),
    )


register("deepseek-v2-lite-16b", full, smoke)
