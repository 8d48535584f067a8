"""Architecture and shape configuration of the port's LM zoo.

The port serves every family of the reference: the decoder-only dense,
MoE, SSM (Mamba2), hybrid (Mamba2 with one shared attention block) and VLM
(patch embeddings projected in front of the tokens) families, and the
encoder-decoder (whisper) family, with the SwiGLU, squared-ReLU or GELU
MLP.  :func:`shape_applicable` is the reference's skip rule for the
(arch x shape) cells of the dry-run.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, Optional, Tuple

# Attention implementations (``ArchConfig.attn_impl``): the hand-written
# CUDA flash kernel, the plain blocked online-softmax loop, and the plain
# version that materialises the scores.
ATTN_IMPLS = ("kernel", "chunked", "xla")
# The reference's names for the same three ("pallas" is its TPU kernel).
_REFERENCE_ATTN_IMPL = {"pallas": "kernel", "chunked": "chunked", "xla": "xla"}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
MLPS = ("swiglu", "sqrelu", "gelu")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    capacity_factor: float = 1.25
    impl: str = "sparse"  # "sparse" (capacity dispatch) | "dense" (all experts)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    """One architecture (``configs/<id>.py``)."""

    arch_id: str
    family: str  # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"  # one of MLPS
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared* attention block after every k core blocks
    shared_attn_every: Optional[int] = None
    # encoder-decoder (whisper): encoder depth and length (precomputed frames)
    n_encoder_layers: int = 0
    n_frames: int = 0
    # vlm (llava): patch embeddings projected in front of the tokens
    n_patches: int = 0
    d_vision: int = 0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "kernel"  # one of ATTN_IMPLS
    # Training: recompute each block's activations in the backward pass
    # (torch.utils.checkpoint), as the reference's jax.checkpoint.
    remat: bool = True
    source: str = ""

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"family '{self.family}' not in {FAMILIES}")
        if self.mlp not in MLPS:
            raise ValueError(f"mlp '{self.mlp}' not in {MLPS}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl '{self.attn_impl}' not in {ATTN_IMPLS}")

    @property
    def hd(self) -> int:
        """Attention head size; an attention-free model (mamba2, ``n_heads``
        0) has none and never asks."""
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context?  (The SSM and hybrid
        families, and sliding-window attention.)"""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's rule)."""
        kv_ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        heads = min(self.n_heads, 4)
        kv = max(1, heads // min(kv_ratio, max(heads, 1))) if heads else 0
        changes: Dict = dict(
            n_layers=min(self.n_layers, 2 if self.shared_attn_every is None else 4),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab=256,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            changes["moe"] = replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                                     top_k=min(self.moe.top_k, 2), d_ff=64)
        if self.ssm is not None:
            changes["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.n_encoder_layers:
            changes["n_encoder_layers"] = 2
            changes["n_frames"] = 32
        if self.n_patches:
            changes["n_patches"] = 16
            changes["d_vision"] = 32
        if self.shared_attn_every is not None:
            changes["shared_attn_every"] = 2
        return replace(self, **changes)


def arch_from_reference(ref) -> ArchConfig:
    """The port's config for a reference ``ArchConfig`` (any object with its
    attributes): same fields, the nested MoE and SSM configs converted, and
    the reference's ``attn_impl`` names mapped onto the port's ("pallas" ->
    "kernel")."""
    kw = {f.name: getattr(ref, f.name) for f in fields(ArchConfig)}
    kw["attn_impl"] = _REFERENCE_ATTN_IMPL[ref.attn_impl]
    for name, cls in (("moe", MoEConfig), ("ssm", SSMConfig)):
        if kw[name] is not None:
            kw[name] = cls(**{f.name: getattr(kw[name], f.name) for f in fields(cls)})
    return ArchConfig(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input shape x step kind) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The reference's skip rule -> (runs, reason-if-skipped)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "long_500k needs sub-quadratic attention (pure full-attn arch)"
    return True, ""
