"""Plain forward of granite-4.0-h (``granitemoehybrid``) on the harness's
weights, for the comparison that decides ``correct``.

Written from the published modeling code's equations, with no cache, no
batching and nothing of the program:

- the embedding times ``embedding_multiplier``;
- each layer: ``h = x + residual_multiplier * mixer(rmsnorm1(x))``, then
  ``h + residual_multiplier * (moe(rmsnorm2(h)) + shared(rmsnorm2(h)))``;
- a mixer is a Mamba-2 block (the SSD recurrence of arXiv:2405.21060, a
  scalar decay a head, one group; a causal depthwise conv with a bias
  before it, a gated RMSNorm after) or grouped-query attention without
  position embeddings, its scores scaled by ``attention_multiplier``;
- the router keeps the top ``num_experts_per_tok`` of its float32 logits
  and weighs those experts by a softmax over them; an expert and the shared
  expert compute ``down(silu(x W_gate) * x W_up)``;
- the tied head over the final RMSNorm, divided by ``logits_scaling``.

So that it fits beside the weights on the card at 8k tokens, the
recurrence runs in blocks of ``mamba_chunk_size`` (a masked quadratic form
within a block, the recurrence across blocks), attention in blocks of 1,024
queries, each expert on its own rows, and each weight matrix is cast to
the compute dtype only for its product.

Departures from the published modeling code: an expert's gate and up
projections are two matrices where the checkpoint stacks them in one
(``input_linear``), which changes no product; ``dt_bias``, ``A_log`` and
``D`` are float32 leaves; no ``time_step_limit`` clamp (the published
default, (0, inf), clamps nothing).  ``tests/plain_granitemoehybrid.py`` is
the copy the program's CPU tests use; the two give the same logits.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.lm import PlainLM, rmsnorm

QUERY_BLOCK = 1024


class GraniteMoeHybrid(PlainLM):
    """``logits(tokens)`` -> (S, V) for one token sequence (S,), layer by
    layer.  ``mixer`` is one method, so that a test can leave one out."""

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        eps = float(c["rms_norm_eps"])
        res = float(c["residual_multiplier"])
        x = self._v(self.w["embed"][tokens]) * float(c["embedding_multiplier"])
        for i, (kind, layer) in enumerate(zip(c["layer_types"], self.w["layers"])):
            h = rmsnorm(x, self._v(layer["ln1"]), eps)
            x = x + res * self.mixer(i, kind, layer, h)
            h = rmsnorm(x, self._v(layer["ln2"]), eps)
            x = x + res * self.ffn(layer, h)
        x = rmsnorm(x, self._v(self.w["ln_f"]), eps)
        # In place: at 8k positions and 100k ids a copy is 3.4 GB beside the weights.
        return self._mm(x, self.w["embed"].T).float().div_(float(c["logits_scaling"]))

    def mixer(self, index: int, kind: str, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        return self.mamba(layer, h) if kind == "mamba" else self.attention(layer, h)

    def mamba(self, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = h.shape[0]
        nh, p, n = int(c["mamba_n_heads"]), int(c["mamba_d_head"]), int(c["mamba_d_state"])
        di = nh * p
        zxbcdt = self._mm(h, layer["in_proj"])
        z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * n], zxbcdt[:, 2 * di + 2 * n:]
        k = int(c["mamba_d_conv"])
        w = self._v(layer["conv_w"])  # (K, C): w[K - 1] multiplies the current input
        xbc = F.conv1d(xbc.T[None], w.T[:, None, :], self._v(layer["conv_b"]), padding=k - 1,
                       groups=xbc.shape[1])[0, :, :s].T
        xbc = F.silu(xbc)
        xs, B, C = xbc[:, :di], xbc[:, di:di + n], xbc[:, di + n:]
        dt = F.softplus(dt.float() + layer["dt_bias"].float())
        A = -torch.exp(layer["A_log"].float())
        xh = xs.reshape(s, nh, p).float()
        y = ssd_blocks(xh, dt, A, B.float(), C.float(), int(c["mamba_chunk_size"]))
        y = (y + layer["D"].float()[None, :, None] * xh).reshape(s, di).to(self.dtype)
        y = rmsnorm(y * F.silu(z), self._v(layer["norm_w"]), float(c["rms_norm_eps"]))
        return self._mm(y, layer["out_proj"])

    def attention(self, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = h.shape[0]
        h_q, h_kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
        hd = int(c["hidden_size"]) // h_q
        q = self._mm(h, layer["wq"]).reshape(s, h_q, hd).transpose(0, 1)
        k = self._mm(h, layer["wk"]).reshape(s, h_kv, hd).transpose(0, 1)
        v = self._mm(h, layer["wv"]).reshape(s, h_kv, hd).transpose(0, 1)
        k = k.repeat_interleave(h_q // h_kv, dim=0)
        v = v.repeat_interleave(h_q // h_kv, dim=0)
        scale = float(c["attention_multiplier"])
        out = []
        for q0 in range(0, s, QUERY_BLOCK):
            qb = q[:, q0:q0 + QUERY_BLOCK]
            rows = torch.arange(q0, q0 + qb.shape[1], device=h.device)
            visible = torch.arange(s, device=h.device)[None, :] <= rows[:, None]
            scores = (qb @ k.transpose(1, 2)) * scale
            out.append(torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1) @ v)
            del scores
        o = torch.cat(out, dim=1).transpose(0, 1).reshape(s, h_q * hd)
        return self._mm(o, layer["wo"])

    def ffn(self, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        top_k = int(self.cfg["num_experts_per_tok"])
        router = h.float() @ layer["router"].float()
        top_vals, top_idx = torch.topk(router, top_k, dim=-1)
        gate = torch.softmax(top_vals, dim=-1).to(self.dtype)
        out = torch.zeros_like(h)
        for e in torch.unique(top_idx).tolist():
            rows, rank = torch.nonzero(top_idx == e, as_tuple=True)
            he = h[rows]
            ye = self._mm(F.silu(self._mm(he, layer["w_gate"][e]))
                          * self._mm(he, layer["w_up"][e]), layer["w_down"][e])
            out.index_add_(0, rows, ye * gate[rows, rank][:, None])
        shared = self._mm(F.silu(self._mm(h, layer["shared_gate"]))
                          * self._mm(h, layer["shared_up"]), layer["shared_down"])
        return out + shared


def ssd_blocks(x, dt, A, B, C, block: int):
    """The SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
    ``y_t = C_t h_t`` in blocks, in float32.  x (S, H, P), dt (S, H), A
    (H,), B and C (S, N) -> y (S, H, P) (without the skip ``D x``)."""
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
        del seg, decay
        y_in = torch.einsum("ijh,jhp->ihp", w, xb)
        y_carry = torch.einsum("in,hpn->ihp", Cb, state) * torch.exp(a)[:, :, None]
        ys.append(y_in + y_carry)
        tail = torch.exp(a[-1][None, :] - a) * dtb  # (q, H): weight of j at the block's end
        state = (torch.exp(a[-1])[:, None, None] * state
                 + torch.einsum("jh,jhp,jn->hpn", tail, xb, Bb))
    return torch.cat(ys)
