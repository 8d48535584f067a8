"""Checkpoints on disk: atomic save/restore of nested trees, async writes.

The port of the JAX package's ``checkpoint/checkpoint.py``, in the same
on-disk format, so a file either package writes restores in the other:

  * leaves are copied to the host and written as one ``.npz``, each under
    the ``/``-join of its path (dict keys in sorted order, sequence
    indices, ``.field`` for a named tuple's fields), plus a JSON manifest
    ``<path>.meta.json`` holding ``step``, ``n_leaves`` and ``extra``;
  * writes go to a temp file then ``os.replace`` (atomic), so a crash
    during save never corrupts the previous checkpoint;
  * the format is device-free: ``restore(..., device=...)`` puts tensor
    leaves on any device;
  * an optional background thread makes saves non-blocking.

A tree is nested dicts, lists and tuples (named ones too) of tensors,
numpy arrays or scalars; ``None`` is an empty subtree.  Dtypes numpy cannot
hold (bfloat16, the float8 types) belong to the training path, which is
not ported yet (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import NOT_TRAINED
from repro_torch.device import DeviceLike, resolve_device

_NUMPY_DTYPES = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64,
    torch.complex64: np.complex64, torch.complex128: np.complex128,
}


def _numpy_dtype(dtype: torch.dtype):
    try:
        return _NUMPY_DTYPES[dtype]
    except KeyError:
        raise TypeError(
            f"checkpoint leaves of dtype {dtype} have no numpy counterpart: "
            f"{NOT_TRAINED}"
        ) from None


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own (never a view of a live tensor)."""
    if isinstance(leaf, torch.Tensor):
        _numpy_dtype(leaf.dtype)
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, str(k)))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), (*path, f".{name}"))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, (*path, str(i)))
    else:
        yield "/".join(path), tree


def _rebuild(like, fn: Callable[[str, Any], Any], path: Tuple[str, ...] = ()):
    """``like``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, (*path, str(k))) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), fn, (*path, f".{f}"))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, fn, (*path, str(i))) for i, x in enumerate(like))
    return fn("/".join(path), like)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _atomic_write(path: str, write: Callable, mode: str) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
        os.replace(tmp, path)  # atomic on POSIX: crash-safe
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, tree, *, step: int, extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomic synchronous save of a tree."""
    flat = _flatten(tree)
    _atomic_write(path, lambda f: np.savez(f, **flat), "wb")
    meta = {"step": int(step), "n_leaves": len(flat), "extra": extra or {}}
    _atomic_write(path + ".meta.json", lambda f: json.dump(meta, f), "w")


class AsyncCheckpointer:
    """Non-blocking saves; at most one outstanding write (latest wins)."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None

    def save(self, path: str, tree, *, step: int, extra=None) -> None:
        # Snapshot to host synchronously (cheap vs write), write async.
        host = _rebuild(tree, lambda _key, leaf: _host(leaf))
        self.wait()
        self._thread = threading.Thread(
            target=save, args=(path, host), kwargs={"step": step, "extra": extra}
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def restore(path: str, like, *, device: Optional[DeviceLike] = None):
    """Restore into the structure of ``like``: ``(tree, step, extra)``.

    Each leaf is cast to its ``like`` leaf's dtype (where it has one).  A
    tensor leaf comes back as a tensor on ``device``, or on its ``like``
    leaf's device (the CPU for a leaf on ``meta``); other leaves come back
    as numpy arrays.
    """
    dev = resolve_device(device) if device is not None else None
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    with np.load(path) as data:

        def leaf(key: str, like_leaf):
            arr = data[key]
            if isinstance(like_leaf, torch.Tensor):
                arr = arr.astype(_numpy_dtype(like_leaf.dtype))
                to = dev or like_leaf.device
                return torch.from_numpy(arr).to("cpu" if to.type == "meta" else to)
            if hasattr(like_leaf, "dtype"):
                arr = arr.astype(like_leaf.dtype)
            return arr

        tree = _rebuild(like, leaf)
    return tree, meta["step"], meta.get("extra", {})
