"""Train-step factory: the loss and gradients by autograd, AdamW, and
microbatched gradient accumulation; remat lives in the model
(``ArchConfig.remat``).

The reference's ``runtime/train_loop.py`` for one card.  Training takes the
reference's training attention, the plain blocked online-softmax loop
(``attn_impl="chunked"``), whatever attention a config serves with: the
flash kernel has no backward (nor had the Pallas kernel it replaces) and
refuses autograd.  The sharded step (``shard_train_step``) is not ported
yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch

from repro_torch.configs.base import NOT_SHARDED, ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adamw import DTYPES, AdamWConfig, AdamWState, make_adamw
from repro_torch.optim.tree import divide, tree_map, value_and_grad

# The attention every training step takes (the reference's default).
TRAIN_ATTN_IMPL = "chunked"


@dataclass(frozen=True)
class TrainRuntime:
    """Per-arch runtime knobs (memory-fit strategy)."""

    microbatches: int = 1
    grad_dtype: Optional[str] = None  # accumulation dtype (None = param dtype)
    adamw: AdamWConfig = AdamWConfig()


# The reference's per-arch overrides.
TRAIN_RUNTIMES: Dict[str, TrainRuntime] = {
    "nemotron-4-340b": TrainRuntime(
        microbatches=4,
        grad_dtype="bfloat16",
        adamw=AdamWConfig(m_dtype="bfloat16", v_dtype="bfloat16", master_dtype=None),
    ),
    "mixtral-8x22b": TrainRuntime(
        microbatches=4,
        grad_dtype="bfloat16",
        adamw=AdamWConfig(m_dtype="bfloat16", v_dtype="bfloat16", master_dtype=None),
    ),
    "llava-next-mistral-7b": TrainRuntime(
        microbatches=2, adamw=AdamWConfig(master_dtype="float32")
    ),
    "whisper-large-v3": TrainRuntime(adamw=AdamWConfig(master_dtype="float32")),
}


def get_runtime(arch_id: str) -> TrainRuntime:
    return TRAIN_RUNTIMES.get(arch_id, TrainRuntime())


def training_config(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with the attention training takes."""
    return replace(cfg, attn_impl=TRAIN_ATTN_IMPL)


def make_grad_fn(cfg: ArchConfig, rt: TrainRuntime):
    """-> ``grad_fn(params, batch) -> (loss, grads)``, the loss and gradients
    of one train step by autograd.  With ``rt.microbatches = k > 1`` the
    batch's leaves are (k, B/k, ...): the gradients accumulate ``g / k`` in
    ``rt.grad_dtype`` and the loss ``loss / k``, one microbatch after
    another."""
    loss_fn = build_model(training_config(cfg)).loss
    k = rt.microbatches
    gdt = DTYPES[rt.grad_dtype]

    def grad_fn(params, batch):
        if k == 1:
            return value_and_grad(loss_fn, params, batch)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt or p.dtype, device=p.device),
                         params)
        loss = None
        for i in range(k):
            mb_loss, g = value_and_grad(loss_fn, params, {name: x[i] for name, x in batch.items()})
            grads = tree_map(lambda a, b: a + divide(b.to(a.dtype), k), grads, g)
            term = divide(mb_loss, k)
            loss = term if loss is None else loss + term
        return loss, grads

    return grad_fn


def make_train_fns(cfg: ArchConfig, rt: TrainRuntime):
    """-> ``(init_fn, train_step)``.

    ``init_fn(generator, device="cuda") -> (params, opt_state)``;
    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    :func:`make_grad_fn`'s loss and gradients, then AdamW; ``metrics``
    holds the 0-d tensors ``loss``, ``lr`` and ``grad_norm``."""
    init = build_model(training_config(cfg)).init
    grad_fn = make_grad_fn(cfg, rt)
    opt_init, opt_update = make_adamw(rt.adamw)

    def init_fn(gen: torch.Generator, device: DeviceLike = "cuda"):
        params = init(gen, resolve_device(device))
        return params, opt_init(params)

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = grad_fn(params, batch)
        new_params, new_opt, metrics = opt_update(grads, opt_state, params)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return init_fn, train_step


# The reference's sharded (pjit) step, not ported yet.
_REFERENCE_ONLY = ("shard_train_step",)


def __getattr__(name: str):
    if name in _REFERENCE_ONLY:
        raise NotImplementedError(f"train_loop.{name}: {NOT_SHARDED}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
