"""``granitemoe``: the decoder-only MoE model of granite-moe's layout.

Pre-norm blocks: RMSNorm, grouped-query attention with rotary embeddings on
interleaved pairs, causal softmax at 1/sqrt(head size); RMSNorm, a router
in float32 whose top-k logits are renormalised by a softmax, and SwiGLU
experts summed by those weights; a final RMSNorm and the head: the
embedding's transpose where the configuration ties them.

Weights: normals over sqrt(fan-in) for every matrix, 0.02 for the
embedding, ones for the norms; the router in float32, as the served model
keeps it, every other leaf in the configuration's dtype.  A configuration
that ties its embeddings has no separate head.  The harness's layout is
``layers``: a dict a block.

FLOPs: what the model requires, not what the program runs: per token 2
FLOPs a parameter the token passes through (attention projections, the
router, ``num_experts_per_tok`` of the experts and, where its logits are
used, the head) plus the attention over its context, 2 x 2 FLOPs a
(query, key) pair a head dimension (scores and weighted values).  A prompt
token's logits are used only at the prompt's last position.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.lm import PlainLM, rmsnorm, rope


def arch_config(c: Dict[str, Any]):
    """The program's ``ArchConfig`` for the configuration file."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    d, h = int(c["hidden_size"]), int(c["num_attention_heads"])
    return ArchConfig(
        arch_id=c["name"], family="moe", n_layers=int(c["num_hidden_layers"]), d_model=d,
        n_heads=h, n_kv_heads=int(c["num_key_value_heads"]), d_ff=int(c["intermediate_size"]),
        vocab=int(c["vocab_size"]), head_dim=d // h, mlp="swiglu",
        rope_theta=float(c["rope_theta"]), tie_embeddings=bool(c["tie_word_embeddings"]),
        norm_eps=float(c["rms_norm_eps"]),
        moe=MoEConfig(n_experts=int(c["num_local_experts"]), top_k=int(c["num_experts_per_tok"]),
                      d_ff=int(c["intermediate_size"]), capacity_factor=float(c["capacity_factor"])),
        param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"],
    )


# -- weights --------------------------------------------------------------------------
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


# -- plain reference --------------------------------------------------------------------
class Reference(PlainLM):
    """``logits(tokens)`` -> (S, V) for one token sequence (S,), layer by
    layer, one sequence at a time."""

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        eps = float(c["rms_norm_eps"])
        h_q, h_kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
        d = int(c["hidden_size"])
        hd = d // h_q
        top_k = int(c["num_experts_per_tok"])
        s = tokens.shape[0]
        x = self._v(self.w["embed"][tokens])
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        for layer in self.w["layers"]:
            h = rmsnorm(x, self._v(layer["ln1"]), eps)
            q = self._mm(h, layer["wq"]).reshape(s, h_q, hd).transpose(0, 1)
            k = self._mm(h, layer["wk"]).reshape(s, h_kv, hd).transpose(0, 1)
            v = self._mm(h, layer["wv"]).reshape(s, h_kv, hd).transpose(0, 1)
            q, k = rope(q, float(c["rope_theta"])), rope(k, float(c["rope_theta"]))
            group = h_q // h_kv
            k = k.repeat_interleave(group, dim=0)
            v = v.repeat_interleave(group, dim=0)
            scores = (q @ k.transpose(1, 2)) * hd**-0.5
            p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            o = (p @ v).transpose(0, 1).reshape(s, h_q * hd)
            x = x + self._mm(o, layer["wo"])
            h = rmsnorm(x, self._v(layer["ln2"]), eps)
            router = h.float() @ layer["router"].float()
            top_vals, top_idx = torch.topk(router, top_k, dim=-1)
            gate = torch.softmax(top_vals, dim=-1).to(self.dtype)
            out = torch.zeros_like(x)
            for e in torch.unique(top_idx).tolist():
                rows, slot = torch.nonzero(top_idx == e, as_tuple=True)
                he = h[rows]
                ye = self._mm(F.silu(self._mm(he, layer["w_gate"][e]))
                              * self._mm(he, layer["w_up"][e]), layer["w_down"][e])
                out.index_add_(0, rows, ye * gate[rows, slot][:, None])
            x = x + out
        x = rmsnorm(x, self._v(self.w["ln_f"]), eps)
        head = self.w["embed"].T if c["tie_word_embeddings"] else self.w["unembed"]
        return self._mm(x, head).float()


# -- model FLOPs ---------------------------------------------------------------------------
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
