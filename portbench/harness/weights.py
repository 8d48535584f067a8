"""Random weights of the served LM, made on the device from the seed.

One ``torch.Generator`` on the device draws each group of leaves that share
a dtype and a scale in one call into one flat buffer, and the leaves are
views of it: a handful of large calls, not one a leaf, and nothing made on
the host.  The scales are the usual ones: normals over sqrt(fan-in) for
every matrix, 0.02 for the embedding, ones for the norms.  A configuration
that ties its embeddings has no separate head.  The router is
float32, as the served model keeps it; every other leaf is in the
configuration's dtype.

The layout is the harness's own (``layers``: a dict a block); the plain
reference reads it as it is, and :func:`program_tree` hands the same
tensors to the program under its own leaf names.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def leaf_specs(c: Dict) -> List[Tuple[Tuple, Tuple[int, ...], str, float]]:
    """(path, shape, dtype name, scale) of every leaf; scale 0 means ones."""
    d, v = int(c["hidden_size"]), int(c["vocab_size"])
    h_q, h_kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
    hd = d // h_q
    e, f = int(c["num_local_experts"]), int(c["intermediate_size"])
    dt = c["torch_dtype"]
    specs = [(("embed",), (v, d), dt, 0.02), (("ln_f",), (d,), dt, 0.0)]
    if not c["tie_word_embeddings"]:
        specs.append((("unembed",), (d, v), dt, d**-0.5))
    for i in range(int(c["num_hidden_layers"])):
        L = ("layers", i)
        specs += [
            (L + ("ln1",), (d,), dt, 0.0), (L + ("ln2",), (d,), dt, 0.0),
            (L + ("wq",), (d, h_q * hd), dt, d**-0.5),
            (L + ("wk",), (d, h_kv * hd), dt, d**-0.5),
            (L + ("wv",), (d, h_kv * hd), dt, d**-0.5),
            (L + ("wo",), (h_q * hd, d), dt, (h_q * hd) ** -0.5),
            (L + ("router",), (d, e), "float32", d**-0.5),
            (L + ("w_gate",), (e, d, f), dt, d**-0.5),
            (L + ("w_up",), (e, d, f), dt, d**-0.5),
            (L + ("w_down",), (e, f, d), dt, f**-0.5),
        ]
    return specs


def make_weights(c: Dict, seed: int, device) -> Dict:
    """The weight tree for configuration ``c`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    groups: Dict[Tuple[str, float], List] = {}
    for spec in leaf_specs(c):
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


def program_tree(w: Dict) -> Dict:
    """The same tensors under the program's leaf names (no copies)."""
    blocks = []
    for layer in w["layers"]:
        blocks.append({
            "ln1": layer["ln1"],
            "attn": {k: layer[k] for k in ("wq", "wk", "wv", "wo")},
            "ln2": layer["ln2"],
            "moe": {k: layer[k] for k in ("router", "w_gate", "w_up", "w_down")},
        })
    return {"blocks": blocks, **{k: w[k] for k in ("embed", "ln_f", "unembed") if k in w}}

