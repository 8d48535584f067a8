"""Random weights of the served LM, made on the device from the seed.

What the leaves are, their shapes, dtypes and scales, is the
architecture's (``portbench/archs/<model_type>.py`` ``leaf_specs``).  One
``torch.Generator`` on the device draws each group of leaves that share a
dtype and a scale in one call into one flat buffer, and the leaves are
views of it: a handful of large calls, not one a leaf, and nothing made on
the host.

The layout is the harness's own (``layers``: a dict a block); the plain
reference reads it as it is, and the architecture's ``program_tree``
hands the same tensors to the program under its own leaf names.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness.cells import load_arch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def make_weights(c: Dict, seed: int, device, arch: Optional[ModuleType] = None) -> Dict:
    """The weight tree for configuration ``c`` from ``seed``, with the leaves
    of ``arch`` (the module of ``c``'s ``model_type`` when not given)."""
    arch = arch or load_arch(c["model_type"])
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    groups: Dict[Tuple[str, float], List] = {}
    for spec in arch.leaf_specs(c):
        groups.setdefault((spec[2], spec[3]), []).append(spec)
    tree: Dict = {"layers": [dict() for _ in range(int(c["num_hidden_layers"]))]}
    for (dt, scale), specs in sorted(groups.items()):
        n = sum(_numel(s[1]) for s in specs)
        if scale == 0.0:
            flat = torch.ones(n, dtype=DTYPES[dt], device=device)
        else:
            flat = torch.randn(n, generator=gen, dtype=DTYPES[dt], device=device)
            flat.mul_(scale)
        off = 0
        for path, shape, _, _ in specs:
            k = _numel(shape)
            leaf = flat[off: off + k].view(shape)
            off += k
            if path[0] == "layers":
                tree["layers"][path[1]][path[2]] = leaf
            else:
                tree[path[0]] = leaf
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def program_tree(w: Dict, c: Dict) -> Dict:
    """The same tensors under the program's leaf names for ``c``'s
    ``model_type`` (no copies)."""
    return load_arch(c["model_type"]).program_tree(w)
