"""Architecture modules (``portbench/archs/<model_type>.py``): granitemoe's
configuration, weights, reference and FLOP counts as they were before they
moved into its module, an unknown ``model_type`` refused at set-up, and a
new architecture served, judged and caught by its reference as new files
alone.  Small sizes, on the CPU."""
from __future__ import annotations

import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench.harness import cells
from portbench.harness.serving import arch_config, tally_deltas
from portbench.harness.weights import make_weights, program_tree
from portbench.reference import lm as ref_lm

ROOT = cells.ROOT

# Read before the granitemoe code moved into ``archs/granitemoe.py``: the
# same seed has to give the same tensors, the same configuration, the same
# counts and the same logits, bit for bit.
GOLDEN = {
    "weights": "add2bc8f0c8256fad37f0bbd401fb6e5c3a7c872deab767c3df909e426aed79d",
    "weights_bf16": "9e5ef939954c735dd8f25b768ed98e698ecbefbe7871fb3ca784c847a0953cab",
    "logits": "405df933b812c3888c08468e3a0b6d6aad0f335f49c53ed7898ea8eb26aaa77d",
    "control": "4d14059d157fa7999f62e08ecfb52c7e0f36193e15ffba2639e71d26b3286bd0",
    "logits_bf16": "ff02d9b5ac4bd28578434a2be464794ff449bd2b95012e8e4cba92c70ce09208",
    "arch_tiny": (
        "ArchConfig(arch_id='granite-moe-3b-a800m', family='moe', n_layers=2, d_model=64, "
        "n_heads=4, n_kv_heads=2, d_ff=32, vocab=256, head_dim=16, qkv_bias=False, "
        "mlp='swiglu', rope_theta=10000.0, sliding_window=None, tie_embeddings=True, "
        "norm_eps=1e-06, moe=MoEConfig(n_experts=4, top_k=2, d_ff=32, capacity_factor=2.0, "
        "impl='sparse'), ssm=None, shared_attn_every=None, n_encoder_layers=0, n_frames=0, "
        "n_patches=0, d_vision=0, param_dtype='float32', compute_dtype='float32', "
        "attn_impl='kernel', remat=True, source='')"),
    "arch": (
        "ArchConfig(arch_id='granite-moe-3b-a800m', family='moe', n_layers=32, d_model=1536, "
        "n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64, qkv_bias=False, "
        "mlp='swiglu', rope_theta=10000.0, sliding_window=None, tie_embeddings=True, "
        "norm_eps=1e-06, moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, capacity_factor=5.0, "
        "impl='sparse'), ssm=None, shared_attn_every=None, n_encoder_layers=0, n_frames=0, "
        "n_patches=0, d_vision=0, param_dtype='bfloat16', compute_dtype='bfloat16', "
        "attn_impl='kernel', remat=True, source='')"),
    # length: (prompt_flops, decode_token_flops at that position)
    "flops": {1: (1765745664, 1765942272), 16: (26010461184, 1768891392),
              37: (60027380736, 1773020160), 1024: (1756624856064, 1967072256)},
}


def _granite():
    return json.loads((ROOT / "portbench/configs/granite-moe-3b-a800m.json").read_text())


def _tiny_granite(**changes):
    g = _granite()
    return {**tiny.LM["config"], **{k: v for k, v in g.items() if k not in tiny.LM["config"]},
            **changes}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _leaves(w, cfg):
    return [w["layers"][p[1]][p[2]] if p[0] == "layers" else w[p[0]]
            for p, *_ in cells.load_arch("granitemoe").leaf_specs(cfg)]


TOKENS = np.random.default_rng(5).integers(0, 256, size=40)


@pytest.mark.parametrize("dtype, tied, weights, logits", [
    ("float32", True, "weights", "logits"), ("bfloat16", False, "weights_bf16", "logits_bf16")])
def test_granitemoe_weights_and_logits_are_the_parents(dtype, tied, weights, logits):
    cfg = _tiny_granite(torch_dtype=dtype, tie_word_embeddings=tied)
    w = make_weights(cfg, 11, "cpu")
    assert _digest(_leaves(w, cfg)) == GOLDEN[weights]
    tokens = torch.as_tensor(TOKENS)
    assert _digest([ref_lm.Reference(w, cfg).logits(tokens)]) == GOLDEN[logits]
    if dtype == "float32":
        ctl = ref_lm.Reference(w, cfg, quant="fp8").logits(tokens)
        assert _digest([ctl]) == GOLDEN["control"]
    prog = program_tree(w, cfg)
    for i, layer in enumerate(w["layers"]):
        assert all(prog["blocks"][i]["moe"][k] is layer[k] for k in ("router", "w_up"))
        assert prog["blocks"][i]["attn"]["wq"] is layer["wq"]


def test_granitemoe_config_and_counts_are_the_parents():
    assert repr(arch_config(_tiny_granite())) == GOLDEN["arch_tiny"]
    g = _granite()
    assert repr(arch_config(g)) == GOLDEN["arch"]
    gm = cells.load_arch(g["model_type"])
    for n, (prompt, decode) in GOLDEN["flops"].items():
        assert gm.prompt_flops(g, n) == prompt
        assert gm.decode_token_flops(g, n) == decode


def test_unknown_model_type_fails_at_set_up():
    from portbench.run import run_cell

    ctx = tiny.context("granite-batch")
    ctx.overrides["config"]["model_type"] = "no_such_arch"
    with pytest.raises(FileNotFoundError, match=r"portbench/archs/no_such_arch\.py"):
        run_cell(ctx)


def test_tallies_differenced_from_zero():
    before = {"moe_rows computed": 100, "moe_pairs routed": 20}
    after = {"moe_rows computed": 740, "moe_pairs routed": 148, "new tally": 3}
    assert tally_deltas(before, after) == {"moe_rows computed": 640, "moe_pairs routed": 128,
                                           "new tally": 3}


def test_throwaway_architecture_is_new_files(tmp_path, monkeypatch):
    """A new ``model_type`` (a small dense SwiGLU decoder), its
    configuration, a mix and the entries in ``BENCHMARK.json`` are new files
    and entries: the cell is served on the CPU, reports ``tokens_per_s`` and
    is judged correct, and a reference that skips a layer fails it.  No
    copied file changes."""
    from portbench.harness.context import Context
    from portbench.run import run_cell

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    copied = sorted(p.relative_to(root) for p in (root / "portbench").rglob("*") if p.is_file())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "densetoy", "source": "test", "reduced": [], "why": "test",
                             "file": "portbench/configs/densetoy.json"})
    bench["workloads"].append({"name": "densetoy-batch", "config": "densetoy",
                               "traffic": "densetoy-batch", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "tokens_per_s")["workloads"].append(
        "densetoy-batch")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    config = {"name": "densetoy", "model_type": "densetoy", "num_hidden_layers": 2,
              "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
              "intermediate_size": 96, "vocab_size": 256, "rope_theta": 10000.0,
              "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "torch_dtype": "float32",
              "reduced": []}
    (root / "portbench/configs/densetoy.json").write_text(json.dumps(config))
    mix = {**json.loads((ROOT / "portbench/mixes/batch.json").read_text()),
           **tiny.LM["mix"], "n_requests": 64, "limits": {"mean_token_gap": 1e-3}}
    (root / "portbench/mixes/densetoy-batch.json").write_text(json.dumps(mix))
    shutil.copy(ROOT / "portbench/tests/dense_arch.py", root / "portbench/archs/densetoy.py")

    cell = cells.resolve("densetoy-batch", root=root)
    assert cell.files["arch"] == root / "portbench/archs/densetoy.py"

    def run():
        ctx = Context(cell=cell, seed=2**31 + 91, seconds=1.5, trace=False, device="cpu",
                      root=root)
        return json.loads(run_cell(ctx)[0])

    out = run()
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["metrics"]["tokens_per_s"]["value"] > 0

    arch = cells.load_arch("densetoy", root)

    class SkipsALayer(arch.Reference):
        def __init__(self, weights, cfg, **kw):
            super().__init__({**weights, "layers": weights["layers"][:-1]}, cfg, **kw)

    monkeypatch.setattr(arch, "Reference", SkipsALayer)
    assert run()["correct"] is False
    for rel in copied:
        assert (root / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
