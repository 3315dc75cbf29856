"""Config system for the PyTorch port.

Frozen dataclasses + a registry keyed by arch id, copied from the JAX
package's ``repro.config`` so the port has no import of it.  Only the
model and sampler configs the serving path reads are here; the training
configs arrive with the training slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

ATTN_GQA = "gqa"          # grouped-query attention (covers MHA/MQA)
ATTN_MLA = "mla"          # DeepSeek multi-head latent attention

MLP_SWIGLU = "swiglu"
MLP_GELU = "gelu"

MIX_ATTN = "attn"
MIX_LOCAL_ATTN = "local_attn"
MIX_RGLRU = "rglru"
MIX_SSM = "ssm"
MIX_CROSS_ATTN = "cross_attn"


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_moe_layer: int = 0
    d_ff_dense: int = 0
    router_aux_coef: float = 0.01
    dispatch: str = "dense_onehot"
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    n_groups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0
    conv_kernel: int = 4
    block_width: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | dit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0             # 0 -> d_model // n_heads
    attn_kind: str = ATTN_GQA
    mlp_kind: str = MLP_SWIGLU
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    window: int = 4096

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    pattern: Tuple[str, ...] = ()
    remainder: Tuple[str, ...] = ()

    enc_layers: int = 0
    enc_input_dim: int = 0

    n_image_tokens: int = 0
    vision_dim: int = 0

    # dit (diffusion backbone)
    latent_size: int = 0          # latent H=W
    latent_channels: int = 0
    patch: int = 2
    cond_dim: int = 0             # text-embedding dim fed to cross-attn
    cond_len: int = 0

    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"

    # attention implementation for full-sequence paths (kernels.dispatch):
    # "naive" materialises (Sq, Sk) scores; "chunked" is the online-softmax
    # loop; "kernel" runs the hand-written flash-attention kernel on a CUDA
    # tensor (its plain version on a CPU tensor).  head_dim > 256 and
    # non-causal windows fall back to chunked, as in the JAX package.
    attn_impl: str = "naive"
    attn_block: int = 1024        # chunked-attention key-block size

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer mixer list for non-uniform families."""
        if not self.pattern:
            return tuple([MIX_ATTN] * self.n_layers)
        n_blocks = (self.n_layers - len(self.remainder)) // len(self.pattern)
        kinds = tuple(self.pattern) * n_blocks + tuple(self.remainder)
        if len(kinds) != self.n_layers:
            raise ValueError(f"pattern gives {len(kinds)} layers, "
                             f"config says {self.n_layers}")
        return kinds


@dataclass(frozen=True)
class SageConfig:
    """Paper hyper-parameters (Alg. 1/2, Eq. 3)."""
    total_steps: int = 30          # DDIM steps T
    share_ratio: float = 0.3       # beta = (T - T*) / T
    guidance_scale: float = 7.5
    tau_min: float = 0.6
    tau_max: float = 0.9
    group_min: int = 2
    group_max: int = 5
    lambda1: float = 1.0
    lambda2: float = 0.5
    soft_target_stopgrad: bool = True
    adaptive_branch: bool = False  # T* from min pairwise similarity
    shared_uncond_cfg: bool = False  # beyond-paper: share CFG uncond pass
    clip_x0: float = 3.0           # x0-thresholding in the sampler
    sampler: str = "ddim"          # ddim | dpmpp (DPM-Solver++ 2M)
    # per-step update implementation (kernels.dispatch): "reference" is the
    # cfg_combine + samplers.ddim_step pair; "fused" runs the single-pass
    # CFG+DDIM kernel (3 reads / 1 write) on a CUDA tensor.
    step_impl: str = "reference"

    @property
    def branch_point(self) -> int:
        return int(round(self.total_steps * (1.0 - self.share_ratio)))


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]()


def list_archs() -> Sequence[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
