"""Plain PyTorch reference of granite-4.0-h (``granitemoehybrid``), in
float32, that the CPU tests hold the port to.

The forward of the published modeling code, written from its equations with
no cache, no batching and nothing of the port (``repro_torch``) or of JAX:

- the embedding times ``embedding_multiplier``;
- each layer: ``h = x + residual_multiplier * mixer(rmsnorm1(x))``, then
  ``h + residual_multiplier * (moe(rmsnorm2(h)) + shared(rmsnorm2(h)))``;
- a mixer is a Mamba-2 block (the SSD recurrence of arXiv:2405.21060 with a
  scalar decay a head and one group, computed in blocks of
  ``mamba_chunk_size``: a masked quadratic form within a block, the
  recurrence across blocks; a causal depthwise conv with a bias before it,
  a gated RMSNorm after) or grouped-query attention without position
  embeddings, its scores scaled by ``attention_multiplier``;
- the router keeps the top ``num_experts_per_tok`` of its float32 logits
  and weighs those experts by a softmax over them; an expert and the shared
  expert compute ``down(silu(x W_gate) * x W_up)``;
- the tied head over the final RMSNorm, the logits divided by
  ``logits_scaling``.

Departures from the published modeling code: the gate and up projections
of an expert are two matrices where the checkpoint stores them stacked in
one (``input_linear``), which changes no product; ``dt_bias``, ``A_log`` and
``D`` are read in float32 (the modeling code casts ``A_log`` to float32 as
well); no ``time_step_limit`` clamp (the published default, (0, inf), clamps
nothing); no attention or projection biases, as the configuration sets
none.

``omit`` leaves parts out (``embedding_multiplier``,
``attention_multiplier``, ``residual_multiplier``, ``logits_scaling``,
``shared_expert``), so a test can show that the comparison notices each.

Weights are the flat layout a layer: ``ln1``, ``ln2``, the mixer's leaves
(``in_proj``, ``conv_w`` (K, C), ``conv_b``, ``dt_bias``, ``A_log``, ``D``,
``norm_w``, ``out_proj``; or ``wq``, ``wk``, ``wv``, ``wo``, each (in, out))
and the FFN's (``router``, ``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f,
d), ``shared_gate``, ``shared_up``, ``shared_down``), beside ``embed`` and
``ln_f``.
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn.functional as F

OMITTABLE = ("embedding_multiplier", "attention_multiplier", "residual_multiplier",
             "logits_scaling", "shared_expert")


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def ssd_blocks(x, dt, A, B, C, block: int):
    """The SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
    ``y_t = C_t h_t`` in blocks.  x (S, H, P), dt (S, H), A (H,), B and C
    (S, N) -> y (S, H, P) (without the skip ``D x``)."""
    s, h, p = x.shape
    n = B.shape[-1]
    state = x.new_zeros((h, p, n))
    ys = []
    for t0 in range(0, s, block):
        xb, dtb, Bb, Cb = x[t0:t0 + block], dt[t0:t0 + block], B[t0:t0 + block], C[t0:t0 + block]
        q = xb.shape[0]
        a = torch.cumsum(dtb * A, dim=0)  # (q, H): log decay from the block's start
        seg = a[:, None, :] - a[None, :, :]  # (i, j, H)
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
        w = (Cb @ Bb.T)[:, :, None] * decay * dtb[None, :, :]  # (i, j, H)
        y_in = torch.einsum("ijh,jhp->ihp", w, xb)
        y_carry = torch.einsum("in,hpn->ihp", Cb, state) * torch.exp(a)[:, :, None]
        ys.append(y_in + y_carry)
        tail = torch.exp(a[-1][None, :] - a) * dtb  # (q, H): weight of j at the block's end
        state = (torch.exp(a[-1])[:, None, None] * state
                 + torch.einsum("jh,jhp,jn->hpn", tail, xb, Bb))
    return torch.cat(ys)


class PlainGraniteMoeHybrid:
    """``logits(tokens)`` -> (S, V) float32 for one token sequence (S,)."""

    def __init__(self, weights: Dict, cfg: Dict, *, omit: Iterable[str] = ()) -> None:
        self.w = weights
        self.cfg = cfg
        self.omit = set(omit)
        unknown = self.omit - set(OMITTABLE)
        if unknown:
            raise ValueError(f"cannot omit {sorted(unknown)}")

    def _mult(self, key: str, neutral: float) -> float:
        return neutral if key in self.omit else float(self.cfg[key])

    @staticmethod
    def _f(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.float32)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        eps = float(c["rms_norm_eps"])
        res = self._mult("residual_multiplier", 1.0)
        x = self._f(self.w["embed"][tokens]) * self._mult("embedding_multiplier", 1.0)
        for kind, layer in zip(c["layer_types"], self.w["layers"]):
            h = _rmsnorm(x, self._f(layer["ln1"]), eps)
            x = x + res * (self.mamba(layer, h) if kind == "mamba" else self.attention(layer, h))
            h = _rmsnorm(x, self._f(layer["ln2"]), eps)
            x = x + res * self.ffn(layer, h)
        x = _rmsnorm(x, self._f(self.w["ln_f"]), eps)
        return (x @ self._f(self.w["embed"]).T) / self._mult("logits_scaling", 1.0)

    def mamba(self, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = h.shape[0]
        nh, p, n = int(c["mamba_n_heads"]), int(c["mamba_d_head"]), int(c["mamba_d_state"])
        di = nh * p
        zxbcdt = h @ self._f(layer["in_proj"])
        z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * n], zxbcdt[:, 2 * di + 2 * n:]
        k = int(c["mamba_d_conv"])
        w = self._f(layer["conv_w"])  # (K, C): w[K - 1] multiplies the current input
        xbc = F.conv1d(xbc.T[None], w.T[:, None, :], self._f(layer["conv_b"]), padding=k - 1,
                       groups=xbc.shape[1])[0, :, :s].T
        xbc = F.silu(xbc)
        xs, B, C = xbc[:, :di], xbc[:, di:di + n], xbc[:, di + n:]
        dt = F.softplus(dt + self._f(layer["dt_bias"]))
        A = -torch.exp(self._f(layer["A_log"]))
        xh = xs.reshape(s, nh, p)
        y = ssd_blocks(xh, dt, A, B, C, int(c["mamba_chunk_size"]))
        y = (y + self._f(layer["D"])[None, :, None] * xh).reshape(s, di)
        y = _rmsnorm(y * F.silu(z), self._f(layer["norm_w"]), eps=float(c["rms_norm_eps"]))
        return y @ self._f(layer["out_proj"])

    def attention(self, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = h.shape[0]
        h_q, h_kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
        hd = self._f(layer["wq"]).shape[1] // h_q
        q = (h @ self._f(layer["wq"])).reshape(s, h_q, hd).transpose(0, 1)
        k = (h @ self._f(layer["wk"])).reshape(s, h_kv, hd).transpose(0, 1)
        v = (h @ self._f(layer["wv"])).reshape(s, h_kv, hd).transpose(0, 1)
        k = k.repeat_interleave(h_q // h_kv, dim=0)
        v = v.repeat_interleave(h_q // h_kv, dim=0)
        scale = self._mult("attention_multiplier", hd**-0.5)
        causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
        scores = (q @ k.transpose(1, 2)) * scale
        o = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1) @ v
        return o.transpose(0, 1).reshape(s, h_q * hd) @ self._f(layer["wo"])

    def ffn(self, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        top_k = int(self.cfg["num_experts_per_tok"])
        logits = h @ self._f(layer["router"])
        top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
        gate = torch.softmax(top_vals, dim=-1)
        out = torch.zeros_like(h)
        for e in torch.unique(top_idx).tolist():
            rows, rank = torch.nonzero(top_idx == e, as_tuple=True)
            he = h[rows]
            ye = (F.silu(he @ self._f(layer["w_gate"][e])) * (he @ self._f(layer["w_up"][e]))
                  ) @ self._f(layer["w_down"][e])
            out.index_add_(0, rows, ye * gate[rows, rank][:, None])
        if "shared_expert" not in self.omit:
            out = out + (F.silu(h @ self._f(layer["shared_gate"]))
                         * (h @ self._f(layer["shared_up"]))) @ self._f(layer["shared_down"])
        return out


def from_port(params: Dict) -> Dict:
    """The port's parameter tree (``repro_torch.models.lm``) in this flat
    layout: the same tensors, no copies."""
    layers = []
    for b in params["blocks"]:
        mixer = b["mamba"] if "mamba" in b else b["attn"]
        layers.append({"ln1": b["ln1"], "ln2": b["ln2"], **mixer, **b["moe"]})
    return {"embed": params["embed"], "ln_f": params["ln_f"], "layers": layers}


def hf_config(cfg) -> Dict:
    """The published ``config.json`` keys of a port ``ArchConfig`` of the
    layered hybrid."""
    ssm, moe = cfg.ssm, cfg.moe
    return {
        "layer_types": list(cfg.layer_types), "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "residual_multiplier": cfg.residual_multiplier, "logits_scaling": cfg.logits_scaling,
        "mamba_n_heads": ssm.n_heads(cfg.d_model), "mamba_d_head": ssm.head_dim,
        "mamba_d_state": ssm.d_state, "mamba_d_conv": ssm.d_conv,
        "mamba_chunk_size": ssm.chunk, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "num_experts_per_tok": moe.top_k,
    }
