"""Model zoo: training and serving entry points, input shapes and weights
carried across from the reference for every family (dense, MoE, SSM,
hybrid, VLM and the encoder-decoder)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

from . import encdec, lm
from .attention import PagedKVCache
from .layers import Params, dtype_of


@dataclass(frozen=True)
class ModelBundle:
    """The training and serving interface of one architecture."""

    cfg: ArchConfig
    init: Callable  # (generator, device) -> params
    loss: Callable  # (params, batch) -> scalar training loss
    prefill: Callable  # (params, batch) -> last-position logits (B, 1, V)
    decode_init: Callable  # (params, batch, seq_len) -> state
    decode_step: Callable  # (params, state, tokens (B, 1)) -> (logits, state)
    # (params, tokens (B, S), cache_len) -> (last logits (B, 1, V), state):
    # the prefill that also yields the decode state a slot continues from.
    # None for the encoder-decoder, whose decode state comes from the
    # encoder's pass over the frames (decode_init).
    prefill_state: Optional[Callable] = None


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "encdec":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen, device="cuda": encdec.init_params(gen, cfg, device),
            loss=lambda p, b: encdec.lm_loss(p, cfg, b),
            prefill=lambda p, b: encdec.prefill(p, cfg, b),
            decode_init=lambda p, b, s: encdec.init_decode_state(p, cfg, b["frames"], s),
            decode_step=lambda p, st, t: encdec.decode_step(p, cfg, st, t),
        )
    return ModelBundle(
        cfg=cfg,
        init=lambda gen, device="cuda": lm.init_params(gen, cfg, device),
        loss=lambda p, b: lm.lm_loss(p, cfg, b),
        prefill=lambda p, b: lm.prefill(p, cfg, b),
        decode_init=lambda p, b, s: lm.init_decode_state(
            cfg, b["tokens"].shape[0], s, p["embed"].device
        ),
        decode_step=lambda p, st, t: lm.decode_step(p, cfg, st, t),
        prefill_state=lambda p, t, s: lm.prefill_state(p, cfg, t, s),
    )


def input_specs(
    cfg: ArchConfig, shape: ShapeConfig, *, batch_override: Optional[int] = None
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Model inputs of one (arch x shape) cell as ``{name: (shape, dtype)}``:
    the token batch for train and prefill, with the encoder-decoder's frame
    embeddings or the VLM's patch embeddings (which take ``n_patches`` of
    the sequence), and the (B, 1) next tokens for decode (the KV cache
    comes from ``decode_init``)."""
    b = batch_override or shape.global_batch
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int64)}
    emb = dtype_of(cfg.compute_dtype)
    specs = {}
    n_text = shape.seq_len
    if cfg.family == "encdec":
        specs["frames"] = ((b, cfg.n_frames, cfg.d_model), emb)
    elif cfg.family == "vlm":
        n_text = shape.seq_len - cfg.n_patches
        if n_text < 1:
            raise ValueError(f"seq_len {shape.seq_len} must exceed the {cfg.n_patches} patches")
        specs["patches"] = ((b, cfg.n_patches, cfg.d_vision), emb)
    specs["tokens"] = ((b, n_text), torch.int64)
    if shape.kind == "train":
        specs["labels"] = ((b, n_text), torch.int64)
    return specs


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree on the ``meta`` device: shapes and dtypes, nothing
    allocated or drawn (the dry-run and the sharding layouts)."""
    return build_model(cfg).init(None, "meta")


def abstract_decode_state(cfg: ArchConfig, shape: ShapeConfig):
    """The decode state of a ``shape.kind == "decode"`` cell on the ``meta``
    device (the encoder-decoder's from an encoder pass over meta frames).
    The pass takes the plain blocked attention, which meta tensors run; the
    shapes are the config's attention's."""
    meta_cfg = replace(cfg, attn_impl="chunked")
    bundle = build_model(meta_cfg)
    params = abstract_params(meta_cfg)
    b = shape.global_batch
    if cfg.family == "encdec":
        frames = torch.empty((b, cfg.n_frames, cfg.d_model), dtype=dtype_of(cfg.compute_dtype),
                             device="meta")
        return bundle.decode_init(params, {"frames": frames}, shape.seq_len)
    tokens = torch.empty((b, 1), dtype=torch.int64, device="meta")
    return bundle.decode_init(params, {"tokens": tokens}, shape.seq_len)


def abstract_inputs(cfg: ArchConfig, shape: ShapeConfig, **kw) -> Dict[str, torch.Tensor]:
    """:func:`input_specs` as ``meta`` tensors."""
    return {name: torch.empty(s, dtype=dt, device="meta")
            for name, (s, dt) in input_specs(cfg, shape, **kw).items()}


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------
def _to_tensor(a: Any, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """``a`` on ``device`` in ``dtype`` (None: its own dtype)."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _per_layer(tree: Dict, n_layers: int) -> List[Dict]:
    """A tree whose leaves are stacked on axis 0 -> one tree per layer."""

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    return [take(tree, i) for i in range(n_layers)]


def _convert(node, device):
    """A reference subtree with each leaf in its own dtype (the router and
    the SSM's ``dt_bias``, ``A_log`` and ``D`` stay fp32 in a bf16 model)."""
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    return _to_tensor(node, None, device)


def _flat_groups(tree: Dict, n_groups: int) -> Dict:
    """Leaves stacked (n_groups, every, ...) -> (n_groups * every, ...)."""
    if isinstance(tree, dict):
        return {k: _flat_groups(v, n_groups) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


# The reference's parameter groups: per-layer stacks, and the rest.
_LAYER_GROUPS = ("blocks", "blocks_tail", "enc_blocks", "dec_blocks")
_GROUPS = (*_LAYER_GROUPS, "shared", "embed", "ln_f", "unembed", "projector", "ln_enc")


def params_from_reference(tree: Dict, cfg: ArchConfig, device="cuda") -> Params:
    """The port's parameters from the reference's ``lm.init_params`` or
    ``encdec.init_params`` tree (numpy arrays; the layers stacked on axis
    0), each leaf in its own dtype.  The hybrid's grouped ``blocks``
    (n_groups, every, ...) and its ``blocks_tail`` become one list of
    layers; ``shared`` and the VLM's ``projector`` stay one set of tensors;
    the encoder-decoder's ``enc_blocks`` and ``dec_blocks`` become lists.
    A tree of the same structure (the reference's gradients, or AdamW's
    ``m``, ``v`` and ``master``) carries across the same way."""
    extra = sorted(set(tree) - set(_GROUPS))
    if extra:
        raise ValueError(f"unknown parameter groups {extra}")
    params = {k: _convert(v, device) for k, v in tree.items() if k not in _LAYER_GROUPS}
    if cfg.family == "encdec":
        for group, n in (("enc_blocks", cfg.n_encoder_layers), ("dec_blocks", cfg.n_layers)):
            params[group] = [_convert(b, device) for b in _per_layer(tree[group], n)]
        return params
    if cfg.shared_attn_every:
        n_groups = cfg.n_layers // cfg.shared_attn_every
        layers = _per_layer(_flat_groups(tree["blocks"], n_groups), n_groups * cfg.shared_attn_every)
        if "blocks_tail" in tree:
            layers += _per_layer(tree["blocks_tail"], cfg.n_layers % cfg.shared_attn_every)
    else:
        layers = _per_layer(tree["blocks"], cfg.n_layers)
    params["blocks"] = [_convert(b, device) for b in layers]
    return params


def paged_state_from_reference(ref_state: Any, cfg: ArchConfig,
                               device="cuda") -> lm.PagedDecodeState:
    """The port's :class:`~repro_torch.models.lm.PagedDecodeState` from the
    reference's (numpy leaves): the block pool (stacked over layers, as the
    port's) in ``cfg.compute_dtype``, tables and positions in int64, and for
    ssm the recurrent state, the reference's (n_slots, L, 1, ...) stacked
    into the port's (L, n_slots, ...) in its own dtype."""
    dtype = dtype_of(cfg.compute_dtype)
    pos = _to_tensor(ref_state.pos, torch.int64, device)
    if ref_state.ssm_h is not None:
        h, conv = (_convert(np.asarray(a)[:, :, 0].swapaxes(0, 1), device)
                   for a in (ref_state.ssm_h, ref_state.ssm_conv))
        return lm.PagedDecodeState(kv=None, tables=None, pos=pos, ssm_h=h, ssm_conv=conv)
    kv = PagedKVCache(
        k=_to_tensor(ref_state.kv.k, dtype, device), v=_to_tensor(ref_state.kv.v, dtype, device)
    )
    return lm.PagedDecodeState(kv=kv, tables=_to_tensor(ref_state.tables, torch.int64, device),
                               pos=pos)
