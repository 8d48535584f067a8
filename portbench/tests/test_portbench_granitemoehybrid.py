"""``archs/granitemoehybrid.py`` (granite-4.0-h-small): its leaves are the
program's, its reference agrees with the program's test copy, its FLOP
counts hold together, and a small cell of it is served through the open
loop on the CPU and judged, with a reference that skips a mixer caught.
Small sizes, on the CPU."""
from __future__ import annotations

import dataclasses
import json
import sys

import pytest
import torch

from portbench.tests import tiny
from portbench.harness import cells
from portbench.harness.context import Context
from portbench.harness.weights import make_weights

ROOT = cells.ROOT
CELL = "granite-h-rag"
SMALL = {
    "num_hidden_layers": 4, "layer_types": ["mamba", "mamba", "attention", "mamba"],
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 32, "shared_intermediate_size": 48, "num_local_experts": 8,
    "num_experts_per_tok": 2, "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16,
    "mamba_chunk_size": 16, "vocab_size": 256, "torch_dtype": "float32",
    "capacity_factor": 4.0,
}


def _published():
    return json.loads((ROOT / "portbench/configs/granite-4.0-h-small.json").read_text())


def _small():
    return {**_published(), **SMALL}


def _arch():
    return cells.load_arch("granitemoehybrid")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("which", ["small", "published"])
def test_leaf_specs_are_exactly_the_programs_leaves(which):
    """Path, shape and dtype of every leaf the architecture module makes,
    under the program's names, against the program's own parameters (the
    published configuration on the meta device: no memory)."""
    from repro_torch.models import lm

    c = _small() if which == "small" else _published()
    arch = _arch()
    cfg = arch.arch_config(c)
    want = {p: (tuple(t.shape), t.dtype) for p, t in
            _leaves(lm.init_params(torch.Generator(), cfg, "meta"))}
    specs = arch.leaf_specs(c)
    meta = {"layers": [dict() for _ in range(int(c["num_hidden_layers"]))]}
    for path, shape, dt, _ in specs:
        leaf = torch.empty(shape, dtype=getattr(torch, dt), device="meta")
        if path[0] == "layers":
            meta["layers"][path[1]][path[2]] = leaf
        else:
            meta[path[0]] = leaf
    got = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(arch.program_tree(meta))}
    assert got == want
    assert len(specs) == len(want)


def test_published_counts():
    """3.22e10 parameters in the leaves, 8.8e9 a decoded token passes
    through; a one-token prompt costs what decoding position 0 does."""
    c = _published()
    arch = _arch()
    total = sum(torch.Size(s).numel() for _, s, _, _ in arch.leaf_specs(c))
    assert round(total / 1e10, 2) == 3.22
    assert round(arch.active_params(c) / 1e9, 1) == 8.8
    assert arch.prompt_flops(c, 1) == arch.decode_token_flops(c, 0)
    n_mamba = c["layer_types"].count("mamba")
    assert arch.scan_flops_per_token(c) == 4 * 128 * 64 * 128 * n_mamba == 4 * 128 * 64 * 128 * 36
    step = arch.decode_token_flops(c, 101) - arch.decode_token_flops(c, 100)
    assert step == 4 * 4 * 32 * 128  # one more key on each of the 4 attention layers


def test_the_two_reference_copies_give_the_same_logits():
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from plain_granitemoehybrid import PlainGraniteMoeHybrid
    finally:
        sys.path.remove(str(ROOT / "tests"))
    c = _small()
    w = make_weights(c, 11, "cpu", _arch())
    tokens = torch.randint(0, 256, (40,), generator=torch.Generator().manual_seed(1))
    ours = _arch().Reference(w, c, dtype=torch.float32).logits(tokens)
    theirs = PlainGraniteMoeHybrid(w, c).logits(tokens)
    # The same arithmetic in the same order, but for the head's product.
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-6)
    assert ours.abs().max() > 0.01


def test_program_equals_the_reference_on_the_harness_weights():
    """The program's forward over ``program_tree`` of the harness's weights
    against the reference (both float32): the weights reach the program
    under the right names."""
    from repro_torch.models import lm

    c = _small()
    arch = _arch()
    w = make_weights(c, 12, "cpu", arch)
    cfg = dataclasses.replace(arch.arch_config(c), attn_impl="chunked")
    tokens = torch.randint(0, 256, (33,), generator=torch.Generator().manual_seed(2))
    got = lm.forward(arch.program_tree(w), cfg, {"tokens": tokens[None]})[0]
    want = arch.Reference(w, c, dtype=torch.float32).logits(tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def _context(trace=False):
    over = tiny.overrides(CELL)
    over["config"] = dict(SMALL)
    return Context(cell=cells.resolve(CELL), seed=2**31 + 91, seconds=1.5, trace=trace,
                   device="cpu", overrides=over)


class _SkipsAMixer:
    """The reference with the mixer of layer 1 left out."""

    def __init__(self, base):
        self.base = base

    def __call__(self, *a, **kw):
        ref = self.base(*a, **kw)
        mixer = ref.mixer

        def skipping(index, kind, layer, h):
            return torch.zeros_like(h) if index == 1 else mixer(index, kind, layer, h)

        ref.mixer = skipping
        return ref


def test_a_small_cell_is_served_judged_and_a_skipped_mixer_caught(monkeypatch):
    """Through ``serve_open`` on the CPU: every request finishes, the tallies
    count real and padded prefill positions, the judged tokens sit on the
    reference's best; a reference without one mixer fails ``verify()``."""
    from portbench.run import run_cell

    line, checks = run_cell(_context(trace=True))
    out = json.loads(line)
    assert out["correct"] is True and out["failed"] == 0 and all(c.ok for c in checks)
    share = out["metrics"]["prefill_pad_share.rag"]["value"]
    assert 0 < share < 100
    ctx = _context()
    bench = cells.load_driver(ctx.cell).Bench(ctx)
    bench.window()
    assert bench.tallies["prefill tokens"] > 0 and bench.tallies["prefill pad tokens"] > 0
    bench.release()
    assert all(c.ok for c in bench.verify())
    monkeypatch.setattr(bench.model, "Reference", _SkipsAMixer(bench.model.Reference))
    assert not any(c.ok for c in bench.verify())
