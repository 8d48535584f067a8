"""Trees of tensors as the port's models hold them (nested dicts, lists,
tuples and named tuples; ``None`` an empty subtree): leaves in the
reference's flattening order (dict keys sorted), maps over trees of one
structure, and the loss and gradient of a function of a tree."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves, in :func:`tree_leaves`' order,
    replaced by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the corresponding leaves of trees of one structure."""
    columns = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*columns)])


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as IEEE division, on any device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal instead."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def value_and_grad(loss_fn: Callable, params, *args) -> Tuple[torch.Tensor, Any]:
    """``(loss_fn(params, *args), d loss / d params)`` by autograd: the loss
    detached, the gradient a tree of ``params``' structure with each leaf
    in its parameter's dtype (zeros where the loss does not reach it)."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, live), *args)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))
