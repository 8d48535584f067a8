"""Model FLOPs of the served decoder-only MoE model, from its configuration.

What the model requires, not what the program runs: per token 2 FLOPs a
parameter the token passes through (attention projections, the router,
``num_experts_per_tok`` of the experts and, where its logits are used, the
head) plus the attention over its context, 2 x 2 FLOPs a (query, key)
pair a head dimension (scores and weighted values).  A prompt token's
logits are used only at the prompt's last position.
"""
from __future__ import annotations

from typing import Dict


def _dims(c: Dict):
    d = int(c["hidden_size"])
    h = int(c["num_attention_heads"])
    hkv = int(c["num_key_value_heads"])
    hd = d // h
    return d, h, hkv, hd


def layer_params_per_token(c: Dict) -> int:
    """Parameters one token passes through in one block."""
    d, h, hkv, hd = _dims(c)
    e, k, f = int(c["num_local_experts"]), int(c["num_experts_per_tok"]), int(c["intermediate_size"])
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    return attn + d * e + k * 3 * d * f


def head_params(c: Dict) -> int:
    return int(c["hidden_size"]) * int(c["vocab_size"])


def active_params(c: Dict) -> int:
    """Parameters a decoded token passes through (every block and the head)."""
    return int(c["num_hidden_layers"]) * layer_params_per_token(c) + head_params(c)


def attention_flops(c: Dict, position: int) -> int:
    """Attention of one token at ``position`` (0-based) over its context of
    ``position + 1`` keys, every block."""
    _, h, _, hd = _dims(c)
    return 4 * int(c["num_hidden_layers"]) * h * hd * (int(position) + 1)


def decode_token_flops(c: Dict, position: int) -> int:
    return 2 * active_params(c) + attention_flops(c, position)


def prompt_flops(c: Dict, length: int) -> int:
    """A whole prompt of ``length`` tokens, logits at its last position."""
    n = int(length)
    trunk = 2 * int(c["num_hidden_layers"]) * layer_params_per_token(c) * n
    _, h, _, hd = _dims(c)
    attn = 4 * int(c["num_hidden_layers"]) * h * hd * n * (n + 1) // 2
    return trunk + attn + 2 * head_params(c)
