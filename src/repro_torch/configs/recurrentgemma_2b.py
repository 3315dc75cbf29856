"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attn 1:2.  [arXiv:2402.19427]

Layer pattern: (rglru, rglru, local_attn) super-blocks; 26 = 8*3 + 2, the
remainder is two recurrent layers (Griffin puts attention every third layer).
Local attention window 2048 per the paper.
"""
from repro_torch.config import ModelConfig, RGLRUConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256000, head_dim=256,
        mlp_kind="swiglu", window=2048, tie_embeddings=True,
        pattern=("rglru", "rglru", "local_attn"),
        remainder=("rglru", "rglru"),
        rglru=RGLRUConfig(lru_width=2560, conv_kernel=4, block_width=256),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=3, d_model=256, n_heads=2, n_kv_heads=1,
        d_ff=512, vocab=512, head_dim=128,
        mlp_kind="swiglu", window=64, tie_embeddings=True,
        pattern=("rglru", "rglru", "local_attn"),
        remainder=(),
        rglru=RGLRUConfig(lru_width=256, conv_kernel=4, block_width=64),
    )


register("recurrentgemma-2b", full, smoke)
