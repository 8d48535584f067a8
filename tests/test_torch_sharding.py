"""The port's sharding layer against the reference's, allocating nothing.

* Layout parity at full size: for every arch, on a 16 x 16 and a
  2 x 16 x 16 duck-typed mesh, under the TP and the pure-DP policy, the
  port's ``layer_param_spec`` of each per-layer leaf equals the reference's
  ``param_spec`` of the stacked leaf with the stacked entries dropped
  (qwen2's ``bq`` / ``bk`` / ``bv`` included), and every reference leaf is
  met; ``decode_state_spec`` and ``batch_spec`` equal the reference's on
  the reference's abstract trees; ``choose_policy`` gives the same policy
  for every arch x shape.
* The reference's ``tests/test_sharding.py`` cases, on the port.
* The spec -> DTensor placements function, on a fake process group of 8
  ranks in a subprocess (the group is global to a process).
* The kernels' refusal of tensor subclasses, the configs' skip rule and the
  abstract trees (``meta``) against the reference's shapes.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import abstract_decode_state as jax_abstract_decode_state
from repro.models import abstract_params as jax_abstract_params
from repro.runtime import sharding as jax_sharding
from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.kernels import build
from repro_torch.models import abstract_decode_state, abstract_params, input_specs
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import P, ShardingPolicy, make_policy

REPO = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"single": (("data", 16), ("model", 16)),
          "multi": (("pod", 2), ("data", 16), ("model", 16))}


class FakeMesh:
    """Duck-typed mesh: ShardingPolicy only reads .shape and .axis_names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


class _K:
    def __init__(self, key):
        self.key = key


class Leaf:
    def __init__(self, shape):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    return jax_abstract_params(JAX_ARCHS[name])


def _jax_leaves(tree):
    """{path keys: shape} of a reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = tuple(leaf.shape)
    return out


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, (*path, i))
    else:
        yield path, tree


def _norm(spec):
    """Per-dim entries with one-axis tuples as the axis (JAX's
    PartitionSpec canonicalises ("data",) to "data")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _both_policies(mesh_kind, pure_dp):
    mesh = FakeMesh(MESHES[mesh_kind])
    return jax_sharding.make_policy(mesh, pure_dp=pure_dp), make_policy(mesh, pure_dp=pure_dp)


@pytest.mark.parametrize("pure_dp", [False, True], ids=["tp", "dp"])
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_param_spec_matches_reference_on_stacked_leaves(name, mesh_kind, pure_dp):
    ref_policy, policy = _both_policies(mesh_kind, pure_dp)
    cfg = ARCHS[name]
    ref_leaves = _jax_leaves(_jax_params(name))
    met = set()
    for path, leaf in _port_leaves(abstract_params(cfg)):
        ref_path, stacked = sharding.reference_leaf(cfg, path, leaf.shape)
        assert ref_leaves[ref_path] == stacked, (path, ref_path)
        met.add(ref_path)
        want = jax_sharding.param_spec(ref_policy, [_K(k) for k in ref_path], Leaf(stacked))
        lead = len(stacked) - len(leaf.shape)
        # No reference leaf has a stacked dim sharded at full size.
        assert all(e is None for e in tuple(want)[:lead]), (path, want)
        assert _norm(sharding.layer_param_spec(policy, cfg, path, leaf)) == _norm(want)[lead:]
    assert met == set(ref_leaves)


def test_qwen2_biases_keep_their_model_shard():
    """Trap of the per-layer leaves: the (896,) bias would be replicated by
    the 1-D rule; on the stacked (24, 896) it is split on 'model'."""
    ref_policy, policy = _both_policies("single", False)
    cfg = ARCHS["qwen2-0.5b"]
    leaf = abstract_params(cfg)["blocks"][0]["attn"]["bq"]
    assert tuple(leaf.shape) == (896,)
    assert sharding.layer_param_spec(policy, cfg, ("blocks", 0, "attn", "bq"), leaf) == P("model")
    assert sharding.param_spec(policy, ["blocks", "attn", "bq"], leaf) == P(None)
    assert jax_sharding.param_spec(ref_policy, [_K("blocks"), _K("attn"), _K("bq")],
                                   Leaf((24, 896))) == jax.sharding.PartitionSpec(None, "model")


@pytest.mark.parametrize("pure_dp", [False, True], ids=["tp", "dp"])
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_decode_state_and_batch_specs_match_reference(mesh_kind, pure_dp):
    ref_policy, policy = _both_policies(mesh_kind, pure_dp)
    for name in sorted(JAX_ARCHS):
        for shape_name in ("decode_32k", "long_500k"):
            if not jax_shape_applicable(JAX_ARCHS[name], JAX_SHAPES[shape_name])[0]:
                continue
            state = jax_abstract_decode_state(JAX_ARCHS[name], JAX_SHAPES[shape_name])
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                want = jax_sharding.decode_state_spec(ref_policy, path, leaf)
                assert _norm(sharding.decode_state_spec(policy, path, leaf)) == _norm(want)
        for shape_name, shape in JAX_SHAPES.items():
            for leaf in jax.tree.leaves(dict(_jax_inputs(name, shape))):
                for mb in (False, True):
                    if mb and len(leaf.shape) < 2:
                        continue
                    want = jax_sharding.batch_spec(ref_policy, leaf, microbatched=mb)
                    assert _norm(sharding.batch_spec(policy, leaf, microbatched=mb)) == _norm(want)


def _jax_inputs(name, shape):
    from repro.models import input_specs as jax_input_specs

    return jax_input_specs(JAX_ARCHS[name], shape)


def test_port_decode_state_leaves_take_the_reference_specs():
    """The port's caches and recurrent state are stacked as the reference's
    (the KV cache (L, B, Hkv, W, hd)), so a leaf of the same shape gets the
    same spec; the port's per-row ``pos_buf`` (B, W) and ``pos`` (B,)
    replicate (rank < 4)."""
    ref_policy, policy = _both_policies("single", False)
    for name in ("qwen2-0.5b", "mamba2-1.3b", "zamba2-1.2b", "whisper-large-v3"):
        state = abstract_decode_state(ARCHS[name], SHAPES["decode_32k"])
        for leaf in tree_leaves(state):
            want = jax_sharding.decode_state_spec(ref_policy, None, Leaf(tuple(leaf.shape)))
            assert _norm(sharding.decode_state_spec(policy, None, leaf)) == _norm(want)


@pytest.mark.parametrize("shape_name", sorted(JAX_SHAPES))
def test_choose_policy_matches_reference(shape_name):
    for mesh_kind in MESHES:
        mesh = FakeMesh(MESHES[mesh_kind])
        for name in sorted(JAX_ARCHS):
            for sp in (False, True):
                ref = jax_sharding.choose_policy(JAX_ARCHS[name], JAX_SHAPES[shape_name], mesh,
                                                 seq_parallel=sp)
                got = sharding.choose_policy(ARCHS[name], SHAPES[shape_name], mesh,
                                             seq_parallel=sp)
                assert (got.dp_axes, got.model_axis, got.fsdp, got.seq_parallel) == (
                    ref.dp_axes, ref.model_axis, ref.fsdp, ref.seq_parallel), (name, mesh_kind)


def test_choose_policy_refuses_a_mesh_without_model_axis():
    mesh = FakeMesh((("data", 8),))
    with pytest.raises(KeyError):
        jax_sharding.choose_policy(JAX_ARCHS["qwen2-0.5b"], JAX_SHAPES["train_4k"], mesh)
    with pytest.raises(KeyError):
        sharding.choose_policy(ARCHS["qwen2-0.5b"], SHAPES["train_4k"], mesh)


# -- the reference's tests/test_sharding.py, on the port --------------------
def _policy(pure_dp=False, shape=(("data", 16), ("model", 16))):
    mesh = FakeMesh(shape)
    if pure_dp:
        return ShardingPolicy(mesh=mesh, dp_axes=("data", "model"), model_axis=None)
    return ShardingPolicy(mesh=mesh, dp_axes=("data",))


def test_shard_if_divisibility():
    p = _policy()
    assert p.shard_if(32, "model") == "model"
    assert p.shard_if(14, "model") is None
    assert p.shard_if(0, "model") == "model"


def test_batch_axes_fallback_chain():
    p = _policy(pure_dp=True)
    assert p.batch_axes(256) == ("data", "model")
    assert p.batch_axes(128) == ("data",)
    assert p.batch_axes(7) is None


def test_param_spec_tp_rules():
    p = _policy()
    param_spec = sharding.param_spec
    assert param_spec(p, [_K("embed")], Leaf((32000, 4096))) == P("model", ("data",))
    assert param_spec(p, [_K("blocks"), _K("mlp"), _K("w_up")],
                      Leaf((32, 4096, 14336))) == P(None, ("data",), "model")
    assert param_spec(p, [_K("blocks"), _K("attn"), _K("wo")],
                      Leaf((32, 4096, 4096))) == P(None, "model", ("data",))
    assert param_spec(p, [_K("ln1")], Leaf((4096,))) == P(None)
    assert param_spec(p, [_K("blocks"), _K("attn"), _K("wq")],
                      Leaf((24, 896, 897))) == P(None, ("data",), None)


def test_param_spec_pure_dp_largest_dim():
    p = _policy(pure_dp=True)
    spec = sharding.param_spec(p, [_K("blocks"), _K("mlp"), _K("w_up")], Leaf((32, 896, 4864)))
    assert spec == P(None, None, ("data", "model"))


def test_choose_policy_families():
    mesh = FakeMesh((("data", 16), ("model", 16)))
    assert sharding.choose_policy(ARCHS["qwen2-0.5b"], SHAPES["train_4k"], mesh).model_axis is None
    pol = sharding.choose_policy(ARCHS["nemotron-4-340b"], SHAPES["train_4k"], mesh)
    assert pol.model_axis == "model" and pol.seq_parallel
    assert sharding.choose_policy(ARCHS["mixtral-8x22b"], SHAPES["train_4k"],
                                  mesh).model_axis is None
    assert sharding.choose_policy(ARCHS["qwen2-0.5b"], SHAPES["decode_32k"],
                                  mesh).model_axis == "model"


# -- configs and abstract trees ------------------------------------------------
def test_shape_applicable_and_subquadratic_match_reference():
    for name in sorted(JAX_ARCHS):
        assert ARCHS[name].subquadratic == JAX_ARCHS[name].subquadratic
        for shape_name in JAX_SHAPES:
            assert shape_applicable(ARCHS[name], SHAPES[shape_name]) == jax_shape_applicable(
                JAX_ARCHS[name], JAX_SHAPES[shape_name])


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_abstract_trees_allocate_nothing_and_match_reference(name):
    """``abstract_params`` lives on ``meta`` and holds the reference's
    elements; the decode state's caches have the reference's shapes."""
    params = abstract_params(ARCHS[name])
    leaves = tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    ref = _jax_params(name)
    assert sum(t.numel() for t in leaves) == sum(int(np.prod(x.shape)) for x in
                                                 jax.tree.leaves(ref))
    state = abstract_decode_state(ARCHS[name], SHAPES["decode_32k"])
    ref_state = jax_abstract_decode_state(JAX_ARCHS[name], JAX_SHAPES["decode_32k"])
    mine = {tuple(t.shape) for t in tree_leaves(state) if t.ndim >= 4}
    theirs = {tuple(x.shape) for x in jax.tree.leaves(ref_state) if x.ndim >= 4}
    assert mine == theirs
    assert all(t.device.type == "meta" for t in tree_leaves(state))
    specs = input_specs(ARCHS[name], SHAPES["train_4k"])
    assert {k: s for k, (s, _) in specs.items()} == {
        k: tuple(v.shape) for k, v in _jax_inputs(name, JAX_SHAPES["train_4k"]).items()}


# -- the kernels refuse tensor subclasses ---------------------------------------
def test_require_plain_refuses_fake_tensors_and_dtensors_by_name():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = torch.empty(4)
    with pytest.raises(RuntimeError, match="flash_attention: .*FakeTensor"):
        build.require_plain((fake,), "flash_attention")
    with pytest.raises(RuntimeError, match="swe_fused_step: .*FakeTensor"):
        build.require_plain((torch.zeros(2), fake), "swe_fused_step")
    build.require_plain((torch.zeros(2), torch.nn.Parameter(torch.zeros(2), False)), "k")
    with pytest.raises(RuntimeError, match="no backward"):
        build.require_plain((torch.zeros(2, requires_grad=True),), "k")


# -- spec -> placements, DTensor strategies, on a fake group of 8 ranks ----------
PLACEMENTS_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.runtime import sharding as S
from repro_torch.runtime.sharding import P
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
one = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
out = {}
def show(pl):
    return [repr(p) for p in pl]
out["two_axes"] = show(S.placements(P(("data", "model"), None), mesh))
out["none_batch"] = show(S.placements(P(None, "model", None), mesh))
out["mixed"] = show(S.placements(P(("data",), None, "model"), mesh))
out["scalar"] = show(S.placements(P(), mesh))
out["size_one_axis"] = show(S.placements(P("data", "model"), one))
for bad in (P(("model", "data")), P("model", "model")):
    try:
        S.placements(bad, mesh)
        out.setdefault("refused", []).append(False)
    except ValueError:
        out.setdefault("refused", []).append(True)
# The strategies DTensor lacks: mm / bmm with out_dtype on bf16 DTensors.
from repro_torch.runtime import dtensor_ops
dtensor_ops.register()
with FakeTensorMode(allow_non_fake_inputs=True):
    a = S.distribute(torch.empty(8, 16, dtype=torch.bfloat16), S.NamedSharding(mesh, P(None, "model")))
    b = S.distribute(torch.empty(16, 12, dtype=torch.bfloat16), S.NamedSharding(mesh, P("model", None)))
    c = torch.mm(a, b, out_dtype=torch.float32)
    out["mm_dtype"] = [str(c.dtype), list(c.shape), show(c.placements)]
    a3 = S.distribute(torch.empty(4, 8, 16, dtype=torch.bfloat16), S.NamedSharding(mesh, P("data", None, None)))
    b3 = S.distribute(torch.empty(4, 16, 12, dtype=torch.bfloat16), S.NamedSharding(mesh, P("data", None, "model")))
    c3 = torch.bmm(a3, b3, out_dtype=torch.float32)
    out["bmm_dtype"] = [str(c3.dtype), list(c3.shape), show(c3.placements)]
    s = S.distribute(torch.empty(4, 6, dtype=torch.int64), S.NamedSharding(mesh, P("data", None)))
    out["searchsorted"] = show(torch.searchsorted(s, s).placements)
print("RESULT:" + json.dumps(out))
"""


def _run_script(script, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


def test_spec_to_placements_and_the_added_strategies():
    out = _run_script(PLACEMENTS_SCRIPT)
    assert out["two_axes"] == ["Shard(dim=0)", "Shard(dim=0)"]
    assert out["none_batch"] == ["Replicate()", "Shard(dim=1)"]
    assert out["mixed"] == ["Shard(dim=0)", "Shard(dim=2)"]
    assert out["scalar"] == ["Replicate()", "Replicate()"]
    # A size-1 axis is a split into one piece: replicated.
    assert out["size_one_axis"] == ["Replicate()", "Shard(dim=1)"]
    assert out["refused"] == [True, True]
    assert out["mm_dtype"] == ["torch.float32", [8, 12], ["Replicate()", "Partial(sum)"]]
    assert out["bmm_dtype"] == ["torch.float32", [4, 8, 12], ["Shard(dim=0)", "Shard(dim=2)"]]
    assert out["searchsorted"] == ["Shard(dim=0)", "Replicate()"]


def test_hooks_are_no_ops_without_a_policy_or_on_plain_tensors():
    x = torch.randn(2, 4, 8)
    q = torch.randn(2, 4, 6, 8)
    for fn in (sharding.maybe_constrain, sharding.maybe_constrain_logits,
               sharding.maybe_constrain_ffn, sharding.maybe_reduce):
        assert fn(x) is x
    assert sharding.maybe_constrain_heads(q) is q and sharding.maybe_constrain_moe(q) is q
    assert sharding.maybe_whole_heads(x, 3) is x
    tree = {"w": x}
    assert sharding.gather_params(tree) is tree
    with sharding.activation_sharding(_policy()):
        assert sharding._POLICY.get() is not None
        assert sharding.maybe_constrain(x) is x and sharding.maybe_constrain_heads(q) is q
        assert sharding.gather_params(tree)["w"] is x
    assert sharding._POLICY.get() is None
    cache = torch.zeros(3, 2, 5, 4)
    sharding.write_cache_slot(cache, torch.tensor([0, 4, 2]), torch.ones(3, 2, 4))
    assert cache.sum() == 24 and cache[1, :, 4].eq(1).all()
    out = sharding.rowwise(lambda a, b, c: a * b + c, torch.ones(2, 3), torch.full((3,), 2.0), 1,
                           batched=(True, False, False))
    assert torch.equal(out, torch.full((2, 3), 3.0))


def test_launch_mesh_constants_are_the_cards():
    from repro_torch.launch import mesh

    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.HBM_BW == 3.35e12
    assert "H100" in mesh.CARD and "700" in mesh.CARD
    # 16-rank model groups span two 8-card nodes: the network carries them.
    assert mesh.axis_bandwidth({"data": 16, "model": 16}, "model") == mesh.NETWORK_BW
    assert mesh.axis_bandwidth({"data": 2, "model": 4}, "model") == mesh.NVLINK_BW
    assert mesh.axis_bandwidth({"data": 16, "model": 16}, "data") == mesh.NETWORK_BW
    assert mesh.hbm_per_card() > 0
    assert dataclasses.is_dataclass(sharding.NamedSharding)
