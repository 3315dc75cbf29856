"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attn image layers.  [hf:meta-llama/Llama-3.2-11B-Vision]

Backbone only, as in the JAX package: the ViT vision encoder is a stub,
and callers pass precomputed patch embeddings as ``extras["image_embeds"]``
(n_image_tokens=1024, vision_dim=1280), fed through a learned projector.
Cross-attention every 5th layer: (attn x4, cross_attn) super-block x 8.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, head_dim=128,
        mlp_kind="swiglu", rope_theta=5e5,
        pattern=("attn", "attn", "attn", "attn", "cross_attn"),
        n_image_tokens=1024, vision_dim=1280,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm",
        n_layers=5, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64,
        mlp_kind="swiglu",
        pattern=("attn", "attn", "attn", "attn", "cross_attn"),
        n_image_tokens=16, vision_dim=64,
    )


register("llama-3.2-vision-11b", full, smoke)
