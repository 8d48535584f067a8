"""granite-4.0-h-small (the layered hybrid: Mamba-2 mixers and NoPE attention,
each followed by a MoE FFN with a shared expert) against the plain float32
reference ``tests/plain_granitemoehybrid.py``, on seeded random weights at a
small size on the CPU: one period of the layer pattern (mamba, mamba,
attention, mamba), 8 experts top-2 and the shared expert, every Granite
multiplier on.

Tolerances.  Program and reference both compute in float32 and differ only
in the order of their sums (the chunked scan against the blocked one, the
capacity dispatch against a loop over experts): the logits, of magnitude
about 0.05 at this size, agree to about 4e-8 on an x86 CPU, so
``ATOL`` = 2e-6 leaves 50 times that.  Leaving out any multiplier or the
shared expert moves the logits by at least 0.01, 5,000 times ``ATOL``;
bfloat16 arithmetic would move them by about 1e-4, 50 times ``ATOL``.
A state carried across chunks against one pass is the same sums in other
blocks: ``STATE_ATOL`` = 1e-5 on states of magnitude about 1.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from plain_granitemoehybrid import OMITTABLE, PlainGraniteMoeHybrid, from_port, hf_config
from repro_torch.configs import ARCHS, MoEConfig
from repro_torch.models import build_model, lm
from repro_torch.models.ssm import mamba_block, mamba_decode_step, ssd_chunked, ssd_naive
from repro_torch.runtime.serve_loop import PagedGraphs, ServingEngine

ATOL = 2e-6
STATE_ATOL = 1e-5
ARCH = "granite-4.0-h-small"
CACHE_LEN, BLOCK = 48, 8


def _cfg():
    return dataclasses.replace(
        ARCHS[ARCH].reduced(), attn_impl="chunked",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, capacity_factor=4.0, shared_d_ff=96))


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    params = lm.init_params(torch.Generator().manual_seed(7), cfg, "cpu")
    # Spread the heads' time constants, so that state carries across chunks.
    for b in params["blocks"]:
        if "mamba" in b:
            b["mamba"]["A_log"] = torch.linspace(-4.0, 2.0, b["mamba"]["A_log"].shape[0])
    return cfg, params, PlainGraniteMoeHybrid(from_port(params), hf_config(cfg))


def _tokens(cfg, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, size=n))


def test_reduced_config_is_one_period_with_every_multiplier(model):
    cfg, params, _ = model
    assert cfg.layer_types == ("mamba", "mamba", "attention", "mamba")
    assert [("mamba" in b, "attn" in b, "moe" in b) for b in params["blocks"]] == [
        (True, False, True), (True, False, True), (False, True, True), (True, False, True)]
    assert "shared_gate" in params["blocks"][0]["moe"]
    assert (cfg.embedding_multiplier, cfg.attention_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling) == (12.0, 1 / 128, 0.22, 16.0)


def test_forward_equals_the_plain_reference(model):
    cfg, params, ref = model
    toks = _tokens(cfg, 37, 1)
    got = lm.forward(params, cfg, {"tokens": toks[None]})[0]
    want = ref.logits(toks)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert want.abs().max() > 0.02  # the tolerance is small against the logits


@pytest.mark.parametrize("part", OMITTABLE)
def test_a_reference_without_a_part_fails_the_comparison(model, part):
    cfg, params, _ = model
    toks = _tokens(cfg, 37, 1)
    got = lm.forward(params, cfg, {"tokens": toks[None]})[0]
    short = PlainGraniteMoeHybrid(from_port(params), hf_config(cfg), omit=[part]).logits(toks)
    assert (got - short).abs().max() > 100 * ATOL, part


def _chunk_logits(graphs: PagedGraphs, slot: int, prompt: torch.Tensor, chunk: int):
    """Feed ``prompt`` to ``slot`` in chunks -> logits of each chunk's last
    position, by position."""
    out = {}
    for start in range(0, len(prompt), chunk):
        piece = prompt[start:start + chunk].numpy()
        _, logits = graphs.chunk(slot, piece, start)
        out[start + len(piece) - 1] = logits[0, -1]
    return out


def test_paged_prefill_then_decode_match_the_reference(model):
    """Prompts of 21 and 13 tokens in chunks of 8 (their last chunks of 5
    tokens padded to 8), then greedy decode through the engine's paged pool:
    the served tokens are the engine's, and the logits at each chunk's end
    and at every decode step are the reference's full forward over the
    prompt and the served tokens."""
    cfg, params, ref = model
    prompts = [_tokens(cfg, 21, 2), _tokens(cfg, 13, 3)]
    n_new = 6
    with ServingEngine({"m": cfg}, mode="paged", n_slots=2, cache_len=CACHE_LEN,
                       block_size=BLOCK, prefill_chunk=8, device="cpu",
                       params={"m": params}) as eng:
        gens = [eng.submit("m", p[None].numpy(), n_new) for p in prompts]
        served = [g.result(timeout=120).tokens.tolist() for g in gens]
        pool = next(s for s in eng.lb.servers if s.name.startswith("paged:"))
        assert pool.prefill_chunk == 8
    graphs = PagedGraphs(build_model(cfg), params, n_slots=2, n_blocks=12, block_size=BLOCK,
                         cache_len=CACHE_LEN, name="test", prefill_chunk=8)
    rows = {0: [1, 2, 3, 4, 5, 6], 1: [7, 8, 9, 10, 11, 12]}
    got = []
    for slot, p in enumerate(prompts):
        lm.paged_reset_slot(graphs.state, slot, rows[slot])
        got.append(_chunk_logits(graphs, slot, p, 8))
    assert sorted(graphs.chunks) == [8]
    feed = torch.tensor([served[0][0], served[1][0]])
    for step in range(n_new - 1):
        ids, logits = graphs.step(feed, torch.tensor([True, True]))
        for slot, p in enumerate(prompts):
            got[slot][len(p) + step] = logits[slot, -1]
            assert int(ids[slot]) == served[slot][step + 1]
        feed = torch.tensor([served[0][step + 1], served[1][step + 1]])
    for slot, p in enumerate(prompts):
        seq = torch.cat([p, torch.tensor(served[slot][:-1])])
        want = ref.logits(seq)
        assert served[slot][0] == int(want[len(p) - 1].argmax())
        for position, logits in got[slot].items():
            torch.testing.assert_close(logits, want[position], rtol=0, atol=ATOL)
        assert len(got[slot]) == -(-len(p) // 8) + n_new - 1


def _ssd_inputs(seed, length=40, heads=3, p=4, n=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(length, heads, p, generator=g)
    dt = torch.rand(length, heads, generator=g) * 0.5
    A = -torch.rand(heads, generator=g)
    B = torch.randn(length, n, generator=g)
    C = torch.randn(length, n, generator=g)
    D = torch.randn(heads, generator=g)
    return x, dt, A, B, C, D


def test_ssd_chunked_continues_the_naive_recurrence():
    x, dt, A, B, C, D = _ssd_inputs(0)
    want, want_h = ssd_naive(x, dt, A, B, C, D, torch.zeros(3, 4, 5))
    _, h = ssd_naive(x[:16], dt[:16], A, B[:16], C[:16], D, torch.zeros(3, 4, 5))
    assert h.abs().max() > 0.1  # a non-zero state to continue from
    y, h_end = ssd_chunked(x[16:], dt[16:], A, B[16:], C[16:], D, 8, h)
    torch.testing.assert_close(y, want[16:], rtol=0, atol=STATE_ATOL)
    torch.testing.assert_close(h_end, want_h, rtol=0, atol=STATE_ATOL)
    # Batched, and without a state: as before.
    yb, hb = ssd_chunked(x[None, 16:], dt[None, 16:], A, B[None, 16:], C[None, 16:], D, 8, h[None])
    assert torch.equal(yb[0], y) and torch.equal(hb[0], h_end)
    torch.testing.assert_close(ssd_chunked(x, dt, A, B, C, D, 8), want, rtol=0, atol=STATE_ATOL)


def _mixer(model):
    cfg, params, _ = model
    return cfg, params["blocks"][0]["mamba"]


def _zero_state(cfg, b=1):
    ssm = cfg.ssm
    h = torch.zeros(b, ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state)
    conv = torch.zeros(b, ssm.d_conv - 1, ssm.d_inner(cfg.d_model) + 2 * ssm.d_state)
    return h, conv


def test_mamba_block_in_chunks_of_3_8_5_equals_one_pass(model):
    """The same 16 positions as one pass, from a zero state, and as chunks of
    3, 8 and 5, each from the state the last left: the same outputs and the
    same final SSM state and conv window; the one pass from a zero state
    equals the block without one."""
    cfg, p = _mixer(model)
    x = torch.randn(1, 16, cfg.d_model, generator=torch.Generator().manual_seed(4))
    whole, (h_whole, conv_whole) = mamba_block(p, x, cfg, _zero_state(cfg))
    torch.testing.assert_close(whole, mamba_block(p, x, cfg), rtol=0, atol=ATOL)
    di, width = cfg.ssm.d_inner(cfg.d_model), conv_whole.shape[-1]
    assert torch.equal(conv_whole, (x @ p["in_proj"])[:, -3:, di:di + width])
    state, outs, start = _zero_state(cfg), [], 0
    for n in (3, 8, 5):
        y, state = mamba_block(p, x[:, start:start + n], cfg, state)
        outs.append(y)
        start += n
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, rtol=0, atol=ATOL)
    torch.testing.assert_close(state[0], h_whole, rtol=0, atol=STATE_ATOL)
    assert torch.equal(state[1], conv_whole)
    assert h_whole.abs().max() > 0.1


def test_mamba_block_from_a_state_continues_the_naive_recurrence(model):
    """Decode steps (the exact per-token recurrence) over a prefix, then the
    block over the rest from their state and conv window: the outputs of
    the decode steps carried on."""
    cfg, p = _mixer(model)
    x = torch.randn(1, 20, cfg.d_model, generator=torch.Generator().manual_seed(5))
    h, conv = _zero_state(cfg)
    steps = []
    for t in range(20):
        y, h, conv = mamba_decode_step(p, x[:, t:t + 1], h, conv, cfg)
        steps.append(y)
        if t == 6:
            carried = (h.clone(), conv.clone())
    y, (h_end, conv_end) = mamba_block(p, x[:, 7:], cfg, carried)
    torch.testing.assert_close(y, torch.cat(steps[7:], dim=1), rtol=0, atol=ATOL)
    torch.testing.assert_close(h_end, h, rtol=0, atol=STATE_ATOL)
    # The same inputs, projected one position at a time or all at once.
    torch.testing.assert_close(conv_end, conv, rtol=0, atol=ATOL)


def test_padded_positions_move_no_state_and_no_kv_entry(model):
    """A chunk of 5 real tokens padded to 8 leaves the slot's SSM state,
    conv window, position and blocks as the unpadded chunk of 5 does, with
    the same logits; padding writes the scratch row 0 only."""
    cfg, params, _ = model

    def fresh():
        st = lm.init_paged_state(cfg, 2, 9, BLOCK, CACHE_LEN // BLOCK, CACHE_LEN, "cpu")
        lm.paged_reset_slot(st, 1, [3, 5, 7, 0, 0, 0])
        lm.paged_prefill_chunk(params, cfg, st, torch.tensor(1), _tokens(cfg, 8, 6),
                               torch.tensor(0), CACHE_LEN)
        return st

    real = _tokens(cfg, 5, 7)
    plain, padded = fresh(), fresh()
    _, _, want = lm.paged_prefill_chunk(params, cfg, plain, torch.tensor(1), real,
                                        torch.tensor(8), CACHE_LEN)
    pad = torch.cat([real, torch.tensor([11, 12, 13])])
    new, _, got = lm.paged_prefill_chunk(params, cfg, padded, torch.tensor(1), pad,
                                         torch.tensor(8), CACHE_LEN, torch.tensor(5))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert int(new.pos[1]) == 13
    torch.testing.assert_close(padded.ssm_h, plain.ssm_h, rtol=0, atol=STATE_ATOL)
    assert torch.equal(padded.ssm_conv, plain.ssm_conv)
    for a, b in ((padded.kv.k, plain.kv.k), (padded.kv.v, plain.kv.v)):
        torch.testing.assert_close(a[:, 1:], b[:, 1:], rtol=0, atol=ATOL)
        assert not torch.equal(a[:, 0], b[:, 0])  # the padding went to the scratch row


def test_chunk_graphs_are_bounded_and_tally_their_padding(model):
    """Chunks of 1 .. 40 tokens with a longest chunk of 64 run at 16, 32 and
    64 positions only; the tallies count real and padded positions."""
    from repro_torch.kernels import build

    cfg, params, _ = model
    g = PagedGraphs(build_model(cfg), params, n_slots=1, n_blocks=9, block_size=BLOCK,
                    cache_len=64 + 8, name="bounded", prefill_chunk=64)
    assert [g.padded_length(n) for n in (1, 16, 17, 33, 64)] == [16, 16, 32, 64, 64]
    real, pad = build.tally("prefill tokens"), build.tally("prefill pad tokens")
    r0, p0 = real.value, pad.value
    for n in (1, 5, 20, 40):
        lm.paged_reset_slot(g.state, 0, [1, 2, 3, 4, 5, 6, 7, 8, 9])
        g.chunk(0, _tokens(cfg, n, n).numpy(), 0)
    assert sorted(g.chunks) == [16, 32, 64]
    assert (real.value - r0, pad.value - p0) == (66, 15 + 11 + 12 + 24)


def test_published_widths_and_parameter_counts():
    """The configuration against the source's config.json (the catalog's
    numbers), and its parameters counted on the meta device: 3.22e10, of
    which 8.8e9 a token passes through (10 of 72 experts)."""
    cfg = ARCHS[ARCH]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab) == (
        40, 4096, 32, 8, 128, 100352)
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] == [5, 15, 25, 35]
    ssm, moe = cfg.ssm, cfg.moe
    assert (ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state, ssm.d_conv, ssm.chunk) == (
        128, 64, 128, 4, 256)
    assert (moe.n_experts, moe.top_k, moe.d_ff, moe.shared_d_ff) == (72, 10, 768, 1536)
    assert (cfg.embedding_multiplier, cfg.attention_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.rope_theta, cfg.tie_embeddings, cfg.norm_eps) == (
        12.0, 0.0078125, 0.22, 16.0, 0.0, True, 1e-5)
    params = lm.init_params(torch.Generator(), cfg, "meta")
    total = lm.param_count(params)
    routed = 3 * cfg.d_model * moe.d_ff * moe.n_experts * cfg.n_layers
    active = total - routed * (1 - moe.top_k / moe.n_experts)
    assert round(total / 1e10, 2) == 3.22 and round(active / 1e9, 1) == 8.8
    src = Path(__file__).resolve().parents[1] / "portbench/configs/granite-4.0-h-small.json"
    pub = json.loads(src.read_text())
    assert list(cfg.layer_types) == pub["layer_types"] and pub["reduced"] == []
    assert (pub["mamba_n_heads"], pub["mamba_d_head"], pub["mamba_d_state"]) == (128, 64, 128)
