"""Model and shape configuration of the LM zoo, the port's copy of
``repro.models.config``.

One frozen dataclass covers all ten families; family-specific fields
default to inert values. ``torch_dtype`` takes the place of the reference's
``jnp_dtype``; ``input_specs`` (the dry-run's stand-ins) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int  # 0 for attention-free (rwkv6)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    moe_capacity_factor: float = 1.25
    moe_dense_ff: int = 0  # arctic residual MLP width (defaults to d_ff)

    # attention details
    mlp_type: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False  # qwen family
    rope_theta: float = 1e4
    causal: bool = True  # False for encoder-only (hubert)
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) splits

    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    hybrid_block: int = 0  # zamba2: mamba layers per shared-attention call

    # frontends (vlm/audio stubs)
    frontend_dim: int = 0  # audio: raw frame feature dim
    vision_tokens: int = 0  # vlm: patches per train/prefill sequence

    tie_embeddings: bool = False  # qwen2-1.5b ties embed/unembed

    # numerics / execution
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    seq_chunk: int = 2048  # chunked-attention q block
    ssm_chunk: int = 256  # SSD / WKV chunk length
    norm_eps: float = 1e-5

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def validate(self) -> None:
        if not self.attention_free:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.family in ("moe",):
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family == "hybrid":
            assert self.ssm_state > 0 and self.hybrid_block > 0
            assert self.num_layers % self.hybrid_block == 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell. kind:
    - train:   a train step (tokens + labels, seq_len positions)
    - prefill: a prefill step (forward + KV-cache build)
    - decode:  a serve step (1 new token against a seq_len-long cache)
    """

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpec]:
    """Shape cells that are well-defined for this architecture: encoder-only
    archs have no decode step (no decode_32k, long_500k), and long_500k needs
    sub-quadratic attention, so only ssm and hybrid families keep it."""
    out = dict(LM_SHAPES)
    if cfg.encoder_only:
        out.pop("decode_32k")
        out.pop("long_500k")
    elif cfg.family not in ("ssm", "hybrid"):
        out.pop("long_500k")
    return out
