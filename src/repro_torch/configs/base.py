"""Architecture and shape configuration of the port's LM zoo.

The port serves the dense decoder-only family with the SwiGLU MLP only; the
MoE, SSM, hybrid, encoder-decoder and VLM families of the reference, and its
squared-ReLU MLP, wait (ROADMAP Queue 1 item 8), and asking for them raises
:class:`NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, Optional

# Attention implementations (``ArchConfig.attn_impl``): the hand-written
# CUDA flash kernel, the plain blocked online-softmax loop, and the plain
# version that materialises the scores.
ATTN_IMPLS = ("kernel", "chunked", "xla")
# The reference's names for the same three ("pallas" is its TPU kernel).
_REFERENCE_ATTN_IMPL = {"pallas": "kernel", "chunked": "chunked", "xla": "xla"}
# What a refusal names: the LM families and their parameter groups, the
# training path, and the sharded per-cell entry points.
NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 8)"
NOT_TRAINED = "not ported yet (ROADMAP Queue 1 item 9)"
NOT_SHARDED = "not ported yet (ROADMAP Queue 1 item 10)"


@dataclass(frozen=True)
class ArchConfig:
    """One dense decoder-only architecture (``configs/<id>.py``)."""

    arch_id: str
    family: str  # "dense"; the reference's other families are not ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"  # the only MLP ported
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "kernel"  # one of ATTN_IMPLS
    source: str = ""

    def __post_init__(self) -> None:
        if self.family != "dense":
            raise NotImplementedError(f"family '{self.family}': {NOT_PORTED}")
        if self.mlp != "swiglu":
            raise NotImplementedError(f"mlp '{self.mlp}': {NOT_PORTED}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl '{self.attn_impl}' not in {ATTN_IMPLS}")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's rule)."""
        kv_ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        heads = min(self.n_heads, 4)
        kv = max(1, heads // min(kv_ratio, max(heads, 1))) if heads else 0
        return replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab=256,
            param_dtype="float32",
            compute_dtype="float32",
        )


def arch_from_reference(ref) -> ArchConfig:
    """The port's config for a reference ``ArchConfig`` (any object with its
    attributes): same fields, with the reference's ``attn_impl`` names
    mapped onto the port's ("pallas" -> "kernel")."""
    if ref.family != "dense":
        raise NotImplementedError(f"family '{ref.family}': {NOT_PORTED}")
    kw = {f.name: getattr(ref, f.name) for f in fields(ArchConfig)}
    kw["attn_impl"] = _REFERENCE_ATTN_IMPL[ref.attn_impl]
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

