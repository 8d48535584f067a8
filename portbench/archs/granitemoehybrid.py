"""``granitemoehybrid``: granite-4.0-h's layers, a Mamba-2 mixer or NoPE
attention in each, each followed by a MoE FFN with a shared expert.

A layer: ``h = x + m mixer(rmsnorm(x))``, ``h + m (moe(rmsnorm(h)) +
shared(rmsnorm(h)))`` with the residual multiplier m; the embedding scaled
by ``embedding_multiplier``, attention scores by ``attention_multiplier``,
the tied head's logits divided by ``logits_scaling``.  The plain forward is
``portbench/reference/granitemoehybrid.py``.

Weights: normals over sqrt(fan-in) for every matrix, 1 /
(``embedding_multiplier`` sqrt(d)) for the embedding, so that a token's
scaled embedding has unit norm (drawn at the usual 0.02, the scaled
embedding outweighs the layers in the residual stream, and the tied head
repeats the last token whatever the precision), 0.5 for the conv and 0.1
for its bias, ones for the norms and D; ``dt_bias`` and ``A_log`` normals
of 2.0 in float32, as the program keeps them, so that the heads' time
constants spread from one token to hundreds and a slot's state carries
across chunks; the router in float32.
The layout is ``layers``: a flat dict a layer, which the reference reads
as it is.  A configuration cut in depth keeps the first
``num_hidden_layers`` of ``layer_types``.

FLOPs: what the model requires, not what the program runs: per token 2
FLOPs a parameter the token passes through (the mixer's or the attention's
projections, the router, ``num_experts_per_tok`` experts, the shared expert
and, where its logits are used, the head), plus the attention over its
context on the attention layers (2 x 2 FLOPs a (query, key) pair a head
dimension) and the scan on the Mamba-2 layers (4 H P N a token: the state
update and its read).  A prompt token's logits are used only at the
prompt's last position.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from portbench.reference.granitemoehybrid import GraniteMoeHybrid as Reference  # noqa: F401

MAMBA_LEAVES = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_w", "out_proj")
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down", "shared_gate", "shared_up", "shared_down")


def layer_types(c: Dict) -> List[str]:
    """Each layer's mixer: the first ``num_hidden_layers`` of ``layer_types``
    (a configuration cut in depth keeps its leading layers)."""
    return list(c["layer_types"])[:int(c["num_hidden_layers"])]


def _dims(c: Dict) -> Dict[str, int]:
    d, h = int(c["hidden_size"]), int(c["num_attention_heads"])
    nh, p, n = int(c["mamba_n_heads"]), int(c["mamba_d_head"]), int(c["mamba_d_state"])
    di = nh * p
    return {"d": d, "h": h, "hkv": int(c["num_key_value_heads"]), "hd": d // h, "nh": nh,
            "p": p, "n": n, "di": di, "conv": di + 2 * n, "k": int(c["mamba_d_conv"]),
            "e": int(c["num_local_experts"]), "top": int(c["num_experts_per_tok"]),
            "f": int(c["intermediate_size"]), "fs": int(c["shared_intermediate_size"]),
            "v": int(c["vocab_size"])}


def arch_config(c: Dict[str, Any]):
    """The program's ``ArchConfig`` for the configuration file."""
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

    m = _dims(c)
    expand = m["di"] // m["d"]
    return ArchConfig(
        arch_id=c["name"], family="hybrid", n_layers=int(c["num_hidden_layers"]),
        d_model=m["d"], n_heads=m["h"], n_kv_heads=m["hkv"], head_dim=m["hd"], d_ff=m["f"],
        vocab=m["v"], mlp="swiglu", rope_theta=0.0,
        tie_embeddings=bool(c["tie_word_embeddings"]), norm_eps=float(c["rms_norm_eps"]),
        moe=MoEConfig(n_experts=m["e"], top_k=m["top"], d_ff=m["f"],
                      capacity_factor=float(c["capacity_factor"]), shared_d_ff=m["fs"]),
        ssm=SSMConfig(d_state=m["n"], expand=expand, head_dim=m["p"], d_conv=m["k"],
                      chunk=int(c["mamba_chunk_size"])),
        layer_types=tuple(layer_types(c)),
        embedding_multiplier=float(c["embedding_multiplier"]),
        attention_multiplier=float(c["attention_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        logits_scaling=float(c["logits_scaling"]),
        param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"],
    )


# -- weights --------------------------------------------------------------------------
def leaf_specs(c: Dict) -> List[Tuple[Tuple, Tuple[int, ...], str, float]]:
    """(path, shape, dtype name, scale) of every leaf; scale 0 means ones."""
    m = _dims(c)
    d, di, nh, e, f, fs = m["d"], m["di"], m["nh"], m["e"], m["f"], m["fs"]
    dt = c["torch_dtype"]
    embed_scale = 1.0 / (float(c["embedding_multiplier"]) * d**0.5)
    specs = [(("embed",), (m["v"], d), dt, embed_scale), (("ln_f",), (d,), dt, 0.0)]
    for i, kind in enumerate(layer_types(c)):
        L = ("layers", i)
        specs += [(L + ("ln1",), (d,), dt, 0.0), (L + ("ln2",), (d,), dt, 0.0)]
        if kind == "mamba":
            specs += [
                (L + ("in_proj",), (d, 2 * di + 2 * m["n"] + nh), dt, d**-0.5),
                (L + ("conv_w",), (m["k"], m["conv"]), dt, m["k"] ** -0.5),
                (L + ("conv_b",), (m["conv"],), dt, 0.1),
                (L + ("dt_bias",), (nh,), "float32", 2.0),
                (L + ("A_log",), (nh,), "float32", 2.0),
                (L + ("D",), (nh,), "float32", 0.0),
                (L + ("norm_w",), (di,), dt, 0.0),
                (L + ("out_proj",), (di, d), dt, di**-0.5),
            ]
        else:
            hq, hkv = m["h"] * m["hd"], m["hkv"] * m["hd"]
            specs += [
                (L + ("wq",), (d, hq), dt, d**-0.5), (L + ("wk",), (d, hkv), dt, d**-0.5),
                (L + ("wv",), (d, hkv), dt, d**-0.5), (L + ("wo",), (hq, d), dt, hq**-0.5),
            ]
        specs += [
            (L + ("router",), (d, e), "float32", d**-0.5),
            (L + ("w_gate",), (e, d, f), dt, d**-0.5),
            (L + ("w_up",), (e, d, f), dt, d**-0.5),
            (L + ("w_down",), (e, f, d), dt, f**-0.5),
            (L + ("shared_gate",), (d, fs), dt, d**-0.5),
            (L + ("shared_up",), (d, fs), dt, d**-0.5),
            (L + ("shared_down",), (fs, d), dt, fs**-0.5),
        ]
    return specs


def program_tree(w: Dict) -> Dict:
    """The same tensors under the program's leaf names (no copies)."""
    blocks = []
    for layer in w["layers"]:
        mixer = ("mamba", MAMBA_LEAVES) if "in_proj" in layer else ("attn", ATTN_LEAVES)
        blocks.append({
            "ln1": layer["ln1"],
            mixer[0]: {k: layer[k] for k in mixer[1]},
            "ln2": layer["ln2"],
            "moe": {k: layer[k] for k in MOE_LEAVES},
        })
    return {"blocks": blocks, "embed": w["embed"], "ln_f": w["ln_f"]}


# -- model FLOPs ---------------------------------------------------------------------------
def _n_kinds(c: Dict) -> Tuple[int, int]:
    kinds = layer_types(c)
    return kinds.count("mamba"), kinds.count("attention")


def mixer_params(c: Dict) -> Tuple[int, int]:
    """Parameters of the projections of one Mamba-2 mixer and of one
    attention layer (the matrices a token passes through)."""
    m = _dims(c)
    d, di = m["d"], m["di"]
    mamba = d * (2 * di + 2 * m["n"] + m["nh"]) + di * d + m["k"] * m["conv"]
    attn = 2 * d * m["h"] * m["hd"] + 2 * d * m["hkv"] * m["hd"]
    return mamba, attn


def ffn_params_per_token(c: Dict) -> int:
    """The router, ``num_experts_per_tok`` experts and the shared expert."""
    m = _dims(c)
    return m["d"] * m["e"] + m["top"] * 3 * m["d"] * m["f"] + 3 * m["d"] * m["fs"]


def head_params(c: Dict) -> int:
    return int(c["hidden_size"]) * int(c["vocab_size"])


def trunk_params_per_token(c: Dict) -> int:
    n_mamba, n_attn = _n_kinds(c)
    mamba, attn = mixer_params(c)
    return n_mamba * mamba + n_attn * attn + (n_mamba + n_attn) * ffn_params_per_token(c)


def active_params(c: Dict) -> int:
    """Parameters a decoded token passes through (every layer and the head)."""
    return trunk_params_per_token(c) + head_params(c)


def scan_flops_per_token(c: Dict) -> int:
    m = _dims(c)
    return 4 * m["nh"] * m["p"] * m["n"] * _n_kinds(c)[0]


def attention_flops(c: Dict, position: int) -> int:
    """Attention of one token at ``position`` (0-based) over its context of
    ``position + 1`` keys, every attention layer."""
    m = _dims(c)
    return 4 * _n_kinds(c)[1] * m["h"] * m["hd"] * (int(position) + 1)


def decode_token_flops(c: Dict, position: int) -> int:
    return 2 * active_params(c) + scan_flops_per_token(c) + attention_flops(c, position)


def prompt_flops(c: Dict, length: int) -> int:
    """A whole prompt of ``length`` tokens, logits at its last position."""
    n = int(length)
    m = _dims(c)
    attn = 4 * _n_kinds(c)[1] * m["h"] * m["hd"] * n * (n + 1) // 2
    return (2 * trunk_params_per_token(c) + scan_flops_per_token(c)) * n + attn \
        + 2 * head_params(c)
