"""Serving and training runtime of the port: the continuous-batching LM
engine, the train step, and the sharding layer on ``DeviceMesh`` /
DTensor with the sharded train, prefill and decode steps.

Exports the names of the reference's ``runtime/__init__.py``, imported on
first use, so that the model code can import :mod:`.sharding` (its hooks)
without importing the steps that import the model code."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ShardingPolicy": "sharding",
    "activation_sharding": "sharding",
    "batch_shardings": "sharding",
    "choose_policy": "sharding",
    "decode_state_shardings": "sharding",
    "make_policy": "sharding",
    "maybe_constrain": "sharding",
    "maybe_constrain_heads": "sharding",
    "maybe_constrain_logits": "sharding",
    "params_shardings": "sharding",
    "TrainRuntime": "train_loop",
    "get_runtime": "train_loop",
    "make_train_fns": "train_loop",
    "shard_train_step": "train_loop",
    "shard_decode_step": "serve_loop",
    "shard_prefill_step": "serve_loop",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
