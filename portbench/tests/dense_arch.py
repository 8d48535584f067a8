"""A small dense SwiGLU decoder (``model_type`` ``densetoy``): the
architecture module the throwaway-architecture test copies into
``archs/densetoy.py`` of a checkout, to show that a new architecture is
new files.  Pre-norm blocks of grouped-query attention with rotary
embeddings and a SwiGLU MLP; an untied or tied head."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.lm import PlainLM, rmsnorm, rope


def arch_config(c: Dict[str, Any]):
    from repro_torch.configs.base import ArchConfig

    d, h = int(c["hidden_size"]), int(c["num_attention_heads"])
    return ArchConfig(
        arch_id=c["name"], family="dense", n_layers=int(c["num_hidden_layers"]), d_model=d,
        n_heads=h, n_kv_heads=int(c["num_key_value_heads"]), d_ff=int(c["intermediate_size"]),
        vocab=int(c["vocab_size"]), head_dim=d // h, mlp="swiglu",
        rope_theta=float(c["rope_theta"]), tie_embeddings=bool(c["tie_word_embeddings"]),
        norm_eps=float(c["rms_norm_eps"]),
        param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"],
    )


def leaf_specs(c: Dict) -> List[Tuple[Tuple, Tuple[int, ...], str, float]]:
    d, v, f = int(c["hidden_size"]), int(c["vocab_size"]), int(c["intermediate_size"])
    h_q, h_kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
    hd = d // h_q
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
            (L + ("w_gate",), (d, f), dt, d**-0.5),
            (L + ("w_up",), (d, f), dt, d**-0.5),
            (L + ("w_down",), (f, d), dt, f**-0.5),
        ]
    return specs


def program_tree(w: Dict) -> Dict:
    blocks = [{"ln1": layer["ln1"], "attn": {k: layer[k] for k in ("wq", "wk", "wv", "wo")},
               "ln2": layer["ln2"], "mlp": {k: layer[k] for k in ("w_gate", "w_up", "w_down")}}
              for layer in w["layers"]]
    return {"blocks": blocks, **{k: w[k] for k in ("embed", "ln_f", "unembed") if k in w}}


class Reference(PlainLM):
    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
        h_q, h_kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
        hd = int(c["hidden_size"]) // h_q
        s = tokens.shape[0]
        x = self._v(self.w["embed"][tokens])
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        for layer in self.w["layers"]:
            h = rmsnorm(x, self._v(layer["ln1"]), eps)
            q = rope(self._mm(h, layer["wq"]).reshape(s, h_q, hd).transpose(0, 1), theta)
            k = rope(self._mm(h, layer["wk"]).reshape(s, h_kv, hd).transpose(0, 1), theta)
            v = self._mm(h, layer["wv"]).reshape(s, h_kv, hd).transpose(0, 1)
            k = k.repeat_interleave(h_q // h_kv, dim=0)
            v = v.repeat_interleave(h_q // h_kv, dim=0)
            scores = (q @ k.transpose(1, 2)) * hd**-0.5
            p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            x = x + self._mm((p @ v).transpose(0, 1).reshape(s, h_q * hd), layer["wo"])
            h = rmsnorm(x, self._v(layer["ln2"]), eps)
            x = x + self._mm(F.silu(self._mm(h, layer["w_gate"])) * self._mm(h, layer["w_up"]),
                             layer["w_down"])
        x = rmsnorm(x, self._v(self.w["ln_f"]), eps)
        head = self.w["embed"].T if c["tie_word_embeddings"] else self.w["unembed"]
        return self._mm(x, head).float()


def _layer_params(c: Dict) -> int:
    d, f = int(c["hidden_size"]), int(c["intermediate_size"])
    h, hkv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
    hd = d // h
    return 2 * d * h * hd + 2 * d * hkv * hd + 3 * d * f


def decode_token_flops(c: Dict, position: int) -> int:
    n, d = int(c["num_hidden_layers"]), int(c["hidden_size"])
    return 2 * (n * _layer_params(c) + d * int(c["vocab_size"])) + 4 * n * d * (int(position) + 1)


def prompt_flops(c: Dict, length: int) -> int:
    n, d, m = int(c["num_hidden_layers"]), int(c["hidden_size"]), int(length)
    head = 2 * d * int(c["vocab_size"])
    return 2 * n * _layer_params(c) * m + 4 * n * d * m * (m + 1) // 2 + head
