"""Architecture and shape configuration of the port's LM zoo.

The port serves every family of the reference: the decoder-only dense,
MoE, SSM (Mamba2), hybrid (Mamba2 with one shared attention block) and VLM
(patch embeddings projected in front of the tokens) families, and the
encoder-decoder (whisper) family, with the SwiGLU, squared-ReLU or GELU
MLP.  A hybrid may instead name each layer's mixer (``layer_types``,
granite-4.0-h): a Mamba2 mixer or attention, each followed by the FFN.
:func:`shape_applicable` is the reference's skip rule for the (arch x
shape) cells of the dry-run.
"""
from __future__ import annotations

from dataclasses import MISSING, dataclass, fields, replace
from typing import Dict, Optional, Tuple

# Attention implementations (``ArchConfig.attn_impl``): the hand-written
# CUDA flash kernel, the plain blocked online-softmax loop, and the plain
# version that materialises the scores.
ATTN_IMPLS = ("kernel", "chunked", "xla")
# The reference's names for the same three ("pallas" is its TPU kernel).
_REFERENCE_ATTN_IMPL = {"pallas": "kernel", "chunked": "chunked", "xla": "xla"}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
MLPS = ("swiglu", "sqrelu", "gelu")
# The mixers a layer of ``ArchConfig.layer_types`` may name.
MIXERS = ("mamba", "attention")


def _default(f):
    return f.default_factory() if f.default is MISSING else f.default


def _given_or_default(obj, f):
    """``obj``'s value of field ``f``, or the field's default where ``obj``
    has no such attribute."""
    return getattr(obj, f.name) if hasattr(obj, f.name) else _default(f)


def _repr_set_fields(obj, quiet: Tuple[str, ...]) -> str:
    """The dataclass repr, leaving out the fields of ``quiet`` that hold
    their default: the settings that only some architectures use."""
    parts = [f"{f.name}={getattr(obj, f.name)!r}" for f in fields(obj)
             if f.repr and not (f.name in quiet and getattr(obj, f.name) == _default(f))]
    return f"{type(obj).__name__}({', '.join(parts)})"


@dataclass(frozen=True, repr=False)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    capacity_factor: float = 1.25
    impl: str = "sparse"  # "sparse" (capacity dispatch) | "dense" (all experts)
    # Width of a shared SwiGLU expert that every token passes through beside
    # its routed ones (granite-4.0-h); 0 for none.
    shared_d_ff: int = 0

    def __repr__(self) -> str:
        return _repr_set_fields(self, ("shared_d_ff",))


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


@dataclass(frozen=True, repr=False)
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
    # hybrid (granite-4.0-h): each layer's mixer, one of MIXERS, each followed
    # by the FFN (the MoE where ``moe`` is set); None elsewhere.
    layer_types: Optional[Tuple[str, ...]] = None
    # Granite's multipliers: the embedding's output is scaled by
    # ``embedding_multiplier``, attention scores by ``attention_multiplier``
    # (None: 1/sqrt(head size)), each residual branch by
    # ``residual_multiplier``, and the logits divided by ``logits_scaling``.
    # At their defaults the model computes what it computes without them.
    embedding_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"family '{self.family}' not in {FAMILIES}")
        if self.mlp not in MLPS:
            raise ValueError(f"mlp '{self.mlp}' not in {MLPS}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl '{self.attn_impl}' not in {ATTN_IMPLS}")
        if self.layer_types is not None:
            if self.family != "hybrid" or self.shared_attn_every is not None:
                raise ValueError("layer_types is a setting of the hybrid without a shared block")
            if len(self.layer_types) != self.n_layers or not set(self.layer_types) <= set(MIXERS):
                raise ValueError(f"layer_types must name one of {MIXERS} for each of the "
                                 f"{self.n_layers} layers")

    def __repr__(self) -> str:
        return _repr_set_fields(self, _LAYERED_FIELDS)

    @property
    def hd(self) -> int:
        """Attention head size; an attention-free model (mamba2, ``n_heads``
        0) has none and never asks."""
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attn_scale(self) -> float:
        """The factor of the attention scores."""
        if self.attention_multiplier is not None:
            return self.attention_multiplier
        return self.hd**-0.5

    def mixers(self) -> Tuple[str, ...]:
        """Each layer's mixer: ``layer_types``, or what the family puts in
        every layer (the SSM family's and zamba2's core blocks are Mamba2;
        zamba2's shared block is not a layer)."""
        if self.layer_types is not None:
            return self.layer_types
        kind = "mamba" if self.family in ("ssm", "hybrid") else "attention"
        return (kind,) * self.n_layers

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
        if self.layer_types is not None:
            # Both mixers, attention between Mamba2 layers, in four layers.
            changes["n_layers"] = 4
            changes["layer_types"] = ("mamba", "mamba", "attention", "mamba")
        if self.moe is not None and self.moe.shared_d_ff:
            changes["moe"] = replace(changes["moe"], shared_d_ff=128)
        return replace(self, **changes)


# The fields only the layered hybrid (granite-4.0-h) sets.
_LAYERED_FIELDS = ("layer_types", "embedding_multiplier", "attention_multiplier",
                   "residual_multiplier", "logits_scaling")


def arch_from_reference(ref) -> ArchConfig:
    """The port's config for a reference ``ArchConfig`` (any object with its
    attributes): same fields (the port's own settings, which the reference
    lacks, at their defaults), the nested MoE and SSM configs converted, and
    the reference's ``attn_impl`` names mapped onto the port's ("pallas" ->
    "kernel")."""
    kw = {f.name: _given_or_default(ref, f) for f in fields(ArchConfig)}
    kw["attn_impl"] = _REFERENCE_ATTN_IMPL[ref.attn_impl]
    for name, cls in (("moe", MoEConfig), ("ssm", SSMConfig)):
        if kw[name] is not None:
            kw[name] = cls(**{f.name: _given_or_default(kw[name], f) for f in fields(cls)})
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
