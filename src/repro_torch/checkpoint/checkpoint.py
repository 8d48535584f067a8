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
numpy arrays or scalars; ``None`` is an empty subtree.  A bfloat16 leaf
(the training state) is written as the reference writes one: its raw
2-byte words, numpy's void dtype ``|V2``.  It is restored by
reinterpreting those bytes, not by a cast (numpy has no cast from void to
a number: the reference's own ``restore`` raises on such a file).  Other
dtypes numpy cannot hold (the float8 types) are refused; no state of the
port holds them.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_NUMPY_DTYPES = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64,
    torch.complex64: np.complex64, torch.complex128: np.complex128,
}


# bfloat16 on disk: the raw 2-byte words, as ml_dtypes' bfloat16 arrays
# (the reference's leaves) are saved.
_BF16_ON_DISK = np.dtype("V2")


def _numpy_dtype(dtype: torch.dtype):
    try:
        return _NUMPY_DTYPES[dtype]
    except KeyError:
        raise TypeError(
            f"checkpoint leaves of dtype {dtype} have no numpy counterpart "
            "(bfloat16 is written as raw 2-byte words; the float8 types are not)"
        ) from None


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own (never a view of a live tensor)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_ON_DISK)
        _numpy_dtype(t.dtype)
        return t.numpy()
    return np.array(leaf, copy=True)


def _tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A stored array as a host tensor of ``dtype``: raw 2-byte words (or an
    ml_dtypes bfloat16 array) are bfloat16 reinterpreted; numpy dtypes are
    cast by numpy as before; bfloat16 from a number by PyTorch's rounding."""
    if arr.dtype == _BF16_ON_DISK or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif dtype == torch.bfloat16:
        t = torch.from_numpy(arr)
    else:
        return torch.from_numpy(arr.astype(_numpy_dtype(dtype)))
    return t.to(dtype)


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

    Each leaf is cast to its ``like`` leaf's dtype (where it has one; a
    stored bfloat16 leaf is reinterpreted, then cast).  A tensor leaf
    comes back as a tensor on ``device``, or on its ``like`` leaf's device
    (the CPU for a leaf on ``meta``); other leaves come back as numpy
    arrays.
    """
    dev = resolve_device(device) if device is not None else None
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    with np.load(path) as data:

        def leaf(key: str, like_leaf):
            arr = data[key]
            if isinstance(like_leaf, torch.Tensor):
                to = dev or like_leaf.device
                return _tensor(arr, like_leaf.dtype).to("cpu" if to.type == "meta" else to)
            if hasattr(like_leaf, "dtype"):
                arr = arr.astype(like_leaf.dtype)
            return arr

        tree = _rebuild(like, leaf)
    return tree, meta["step"], meta.get("extra", {})
