"""The sharded train, prefill and decode steps on real process groups.

Torch has no multi-device CPU mesh, so each mesh here is a group of
spawned processes over ``gloo`` (the process group is global to a process:
no pytest worker joins one), 4 ranks or fewer:

* a (2, 2) ``("data", "model")`` mesh: reduced qwen2 with H 4 and Hkv 1
  (q heads split, kv heads not) under the TP and the pure-DP policy with 1
  and 2 microbatches, reduced granite (MoE) and mamba2 (SSM); then
  ``shard_prefill_step`` and 6 ``shard_decode_step``s with
  ``attn_impl="kernel"`` (the flash wrapper's ``local_map`` route, which
  runs the plain version on CPU shards) over a windowed cache whose W dim
  is split (the KV heads do not divide the model axis);
* a (1, 3) mesh at a sequence of 12: the heads do not divide, so
  ``maybe_constrain_heads`` takes the context-parallel route;
* a (1, 1) mesh: every step equals the unsharded one bit for bit.

Each train step is held against ``make_train_fns``' unsharded step on the
same parameters and batch (fp32; loss and grad norm within rtol 1e-5,
parameters within 1e-6), the qwen2 ones also against the reference's
``train_step`` from the same parameters (carried across by
``params_from_reference``) with the bounds of ``tests/test_torch_train.py``,
and every leaf that two ranks hold the same part of must be equal bit for
bit across them (the global-norm clip is one reduction over the whole
mesh).  Prefill and
decode logits and the decode state: within 1e-5 of ``lm.prefill`` /
``lm.decode_step`` (two CPU summation orders; measured < 3e-6).

The same groups run the graph steps (``GraphShardedStep``: on gloo its
function runs eagerly on the static placed buffers a CUDA graph reads on
the card) from each eager step's start: ``graph_train_step`` under both
policies with 1 and 2 microbatches and on the context-parallel route, held
to the same bounds (bit for bit on one rank), its leaves written in place,
a batch of another layout refused, ``load`` + a step equal to the first
step; ``graph_prefill_step`` and ``graph_decode_step`` (the decode state
donated) against ``lm``; and, on the one-rank group, the launcher's
``make_sharded_trainer`` against its one-process trainer and through a
restart from disk.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.runtime.train_loop import TrainRuntime as JaxTrainRuntime
from repro.runtime.train_loop import make_train_fns as jax_make_train_fns
from repro_torch.configs import ARCHS, arch_from_reference
from repro_torch.data import microbatch
from repro_torch.models import build_model, params_from_reference
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import make_adamw
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime.train_loop import TrainRuntime, make_train_fns, training_config

REPO = os.path.join(os.path.dirname(__file__), "..")
ADAMW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=20)
B, S = 8, 12
LOSS_RTOL, PARAM_ATOL, SERVE_ATOL = 1e-5, 1e-6, 1e-5

WORKER = r"""
import json, os, sys, dataclasses
import numpy as np
import torch
import torch.distributed as dist
os.nice(10)  # below the suite's own workers, whose timing tests share the host
rank, world = int(sys.argv[1]), int(sys.argv[2])
spec = json.load(open(sys.argv[3]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.data import microbatch
from repro_torch.models import build_model, lm
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import make_adamw
from repro_torch.optim.tree import tree_leaves, tree_unflatten
from repro_torch.runtime import sharding as S
from repro_torch.runtime.serve_loop import (graph_decode_step, graph_prefill_step,
                                            shard_decode_step, shard_prefill_step)
from repro_torch.runtime.train_loop import (TrainRuntime, graph_train_step, make_train_fns,
                                            shard_train_step)
torch.use_deterministic_algorithms(True)
torch.set_num_threads(1)
mesh = init_device_mesh("cpu", tuple(spec["mesh"]), mesh_dim_names=("data", "model"))

def config(c):
    cfg = ARCHS[c["arch"]].reduced()
    return dataclasses.replace(cfg, **c.get("changes", {}))

def batch_of(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}

def clone(tree):
    return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])

def compare(got, want):
    # (leaves unequal in any bit, largest difference) of two DTensor trees' local shards
    pairs = [(a.to_local(), b.to_local()) for a, b in zip(tree_leaves(got), tree_leaves(want))]
    return (sum(int(not torch.equal(a, b)) for a, b in pairs),
            max(float((a.double() - b.double()).abs().max()) for a, b in pairs))

def metrics_of(m):
    return {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}

def graph_train(fn, p0, o0, b, p2, o2, m):
    # The graph step from the eager step's start: its result against the
    # eager step's, the leaves in place, a refused layout, load + step.
    g = graph_train_step(fn, clone(p0), clone(o0), name="train step")
    ptrs = [t.to_local().data_ptr() for t in tree_leaves(g.args)]
    gm = g(b)
    unequal, diff = compare(g.args, (p2, o2))
    first = clone(g.args)
    out = {"graph": metrics_of(gm), "graph_unequal": unequal, "graph_diff": diff,
           "graph_metrics_equal": metrics_of(gm) == metrics_of(m),
           "in_place": ptrs == [t.to_local().data_ptr() for t in tree_leaves(g.args)]}
    try:
        g({n: x[..., :-1] if n == "labels" else x for n, x in b.items()})
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    g.load(p0, o0)
    again = g(b)
    out["load_unequal"] = compare(g.args, first)[0] + int(metrics_of(again) != metrics_of(gm))
    out["load_in_place"] = ptrs == [t.to_local().data_ptr() for t in tree_leaves(g.args)]
    return out, [t.full_tensor() for t in tree_leaves(first[0])]

def trainer_case(c):
    # The launcher's sharded trainer against its one-process trainer, and
    # a restart through disk into a fresh sharded trainer.
    from repro_torch.checkpoint.checkpoint import save
    from repro_torch.launch.train import make_sharded_trainer, make_trainer
    cfg = config(c)
    kw = dict(steps=8, seq_len=c["s"], batch=c["b"], device="cpu")
    tr, plain = make_sharded_trainer(cfg, **kw), make_trainer(cfg, **kw)
    got = [metrics_of(tr.step(i)) for i in range(3)]
    want = [metrics_of(plain.step(i)) for i in range(3)]
    state = [t.clone() for t in tree_leaves(tr.state)]
    unequal = sum(int(not torch.equal(a, b)) for a, b in zip(state, tree_leaves(plain.state)))
    path = os.path.join(spec["dir"], "trainer.npz")
    if rank == 0:
        save(path, tr.state, step=3)
    dist.barrier()
    fresh = make_sharded_trainer(cfg, **kw)
    start = fresh.restore(path)
    resumed = metrics_of(fresh.step(3)) == metrics_of(tr.step(3))
    resumed &= all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh.state),
                                                     tree_leaves(tr.state)))
    return {"step_type": type(tr.train_step).__name__, "metrics_equal": got == want,
            "state_unequal": unequal, "start": start, "resumed": bool(resumed)}

def replicas_differ(tree):
    # Leaves whose shard two ranks hold alike must be equal bit for bit.
    coords = [None] * world
    dist.all_gather_object(coords, mesh.get_coordinate())
    bad = 0
    for t in tree_leaves(tree):
        loc = t.to_local().contiguous()
        got = [torch.empty_like(loc) for _ in range(world)]
        dist.all_gather(got, loc)
        for r in range(world):
            same = all(coords[r][i] == coords[rank][i]
                       for i, p in enumerate(t.placements) if p.is_shard())
            bad += int(same and not torch.equal(got[r], loc))
    return bad

results = {}
for c in spec["cases"]:
    cfg = config(c)
    policy = S.make_policy(mesh, pure_dp=c.get("pure_dp", False))
    if c["kind"] == "trainer":
        out = trainer_case(c)
    elif c["kind"] == "train":
        k = c["k"]
        rt = TrainRuntime(microbatches=k, adamw=AdamWConfig(**spec["adamw"]))
        init, _ = make_train_fns(cfg, rt)
        params, opt = init(torch.Generator().manual_seed(0), "cpu")
        if "params" in c:
            params = torch.load(c["params"])
            opt = make_adamw(rt.adamw)[0](params)
        shape = ShapeConfig("t", c["s"], c["b"], "train")
        fn, _ = shard_train_step(cfg, shape, policy, rt)
        b = microbatch(batch_of(cfg, c["seed"], c["b"], c["s"]), k)
        p0, o0 = clone(params), clone(opt)  # the eager step writes into what it placed
        p2, o2, m = fn(params, opt, b)
        full = [t.full_tensor() for t in tree_leaves(p2)]
        out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "lr": float(m["lr"]), "bad": replicas_differ((p2, o2))}
        if rank == 0:
            torch.save(full, os.path.join(spec["dir"], c["name"] + ".pt"))
        if c.get("graph"):
            g_out, g_full = graph_train(fn, p0, o0, b, p2, o2, m)
            out.update(g_out)
            if rank == 0:
                torch.save(g_full, os.path.join(spec["dir"], c["name"] + "_graph.pt"))
    else:
        cfg = dataclasses.replace(cfg, attn_impl="kernel")
        params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab, (c["b"], c["s"]), generator=g)
        fn, _ = shard_prefill_step(cfg, ShapeConfig("p", c["s"], c["b"], "prefill"), policy)
        logits = fn(params, {"tokens": tok}).full_tensor()
        out = {"prefill": float((logits - lm.prefill(params, cfg, {"tokens": tok})).abs().max())}
        dfn, _ = shard_decode_step(cfg, ShapeConfig("d", c["cache"], c["b"], "decode"), policy)
        ref = lm.init_decode_state(cfg, c["b"], c["cache"], "cpu")
        st = lm.init_decode_state(cfg, c["b"], c["cache"], "cpu")
        placed = S.place_tree(params, dfn.in_shardings[0])
        errs, steps, wants = [], [], []
        for _ in range(c["steps"]):
            nt = torch.randint(0, cfg.vocab, (c["b"], 1), generator=g)
            want, ref = lm.decode_step(params, cfg, ref, nt)
            got, st = dfn(placed, st, {"tokens": nt})
            errs.append(float((got.full_tensor() - want).abs().max()))
            steps.append(nt)
            wants.append(want)
        out["decode"] = max(errs)
        out["state"] = max(float((a.full_tensor() - b).abs().max())
                           for a, b in zip(tree_leaves(st), tree_leaves(ref)))
        out["w_split"] = any(p.is_shard(3) for p in st.kv.k.placements)
        # The same prefill and decode steps as graphs (eager on gloo).
        gp = graph_prefill_step(fn, params, name="prefill")
        out["graph_prefill"] = float(
            (gp({"tokens": tok}).full_tensor() - lm.prefill(params, cfg, {"tokens": tok})).abs().max())
        gd = graph_decode_step(dfn, params, lm.init_decode_state(cfg, c["b"], c["cache"], "cpu"),
                               name="decode")
        ptrs = [t.to_local().data_ptr() for t in tree_leaves(gd.args[1])]
        out["graph_decode"] = max(float((gd({"tokens": nt}).full_tensor() - want).abs().max())
                                  for nt, want in zip(steps, wants))
        out["graph_state"] = max(float((a.full_tensor() - b).abs().max())
                                 for a, b in zip(tree_leaves(gd.args[1]), tree_leaves(ref)))
        out["graph_in_place"] = ptrs == [t.to_local().data_ptr() for t in tree_leaves(gd.args[1])]
    results[c["name"]] = out
print("RESULT:" + json.dumps({"rank": rank, **results}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(tmp_path, mesh, cases):
    world = int(np.prod(mesh))
    spec = {"mesh": list(mesh), "cases": cases, "adamw": ADAMW, "dir": str(tmp_path),
            "port": _free_port()}
    path = tmp_path / f"spec_{world}.json"
    path.write_text(json.dumps(spec))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=400)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("RESULT:")][0][len("RESULT:"):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _qwen2():
    """Reduced qwen2 with 4 query heads and 1 KV head, both packages."""
    jcfg = dataclasses.replace(JAX_ARCHS["qwen2-0.5b"].reduced(), attn_impl="chunked",
                               n_heads=4, n_kv_heads=1)
    return jcfg, arch_from_reference(jcfg)


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)),
            "labels": rng.integers(0, cfg.vocab, (b, s))}


TRAIN_CASES = [
    # name, arch, pure_dp, microbatches
    ("qwen2_tp_k1", "qwen2-0.5b", False, 1),
    ("qwen2_tp_k2", "qwen2-0.5b", False, 2),
    ("qwen2_dp_k1", "qwen2-0.5b", True, 1),
    ("qwen2_dp_k2", "qwen2-0.5b", True, 2),
    ("granite_tp_k1", "granite-moe-3b-a800m", False, 1),
    ("mamba2_dp_k1", "mamba2-1.3b", True, 1),
]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every spawned group's results: the (2, 2), (1, 3) and (1, 1) meshes."""
    tmp = tmp_path_factory.mktemp("shard_steps")
    jcfg, cfg = _qwen2()
    jparams = jax_make_train_fns(jcfg, JaxTrainRuntime())[0](jax.random.key(0))[0]
    qwen2_params = tmp / "qwen2.pt"
    torch.save(params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu"), qwen2_params)
    qwen2_changes = {"n_heads": 4, "n_kv_heads": 1}
    cases = []
    for name, arch, pure_dp, k in TRAIN_CASES:
        c = {"name": name, "kind": "train", "arch": arch, "pure_dp": pure_dp, "k": k,
             "b": B, "s": S, "seed": 10}
        if arch == "qwen2-0.5b":
            c.update(changes=qwen2_changes, params=str(qwen2_params), graph=True)
        cases.append(c)
    serve = {"name": "serve", "kind": "serve", "arch": "qwen2-0.5b", "b": 4, "s": S,
             "cache": 16, "steps": 6, "changes": {**qwen2_changes, "sliding_window": 4}}
    out = {"2x2": _run_group(tmp, (2, 2), cases + [serve])}
    cp = dict(cases[0], name="qwen2_cp")
    # A window of 6 splits 3 ways.
    out["1x3"] = _run_group(tmp, (1, 3), [cp, dict(serve, b=3, changes={
        **qwen2_changes, "sliding_window": 6})])
    trainer = {"name": "trainer", "kind": "trainer", "arch": "qwen2-0.5b", "b": 4, "s": S}
    one = [dict(cases[0], name="one_tp"), dict(cases[4], name="one_granite"),
           dict(serve, name="one_serve"), trainer]
    out["1x1"] = _run_group(tmp, (1, 1), one)
    out["dir"] = tmp
    out["qwen2_params"] = qwen2_params
    return out


def _unsharded(case, params_path=None):
    """The port's unsharded step on the worker's parameters and batch."""
    name, arch, pure_dp, k = case
    cfg = ARCHS[arch].reduced()
    if arch == "qwen2-0.5b":
        cfg = dataclasses.replace(cfg, n_heads=4, n_kv_heads=1)
    rt = TrainRuntime(microbatches=k, adamw=AdamWConfig(**ADAMW))
    init, step = make_train_fns(cfg, rt)
    params, opt = init(torch.Generator().manual_seed(0), "cpu")
    if params_path is not None:
        params = torch.load(params_path)
        opt = make_adamw(rt.adamw)[0](params)
    batch = {n: torch.from_numpy(v) for n, v in _batch(cfg, 10).items()}
    torch.use_deterministic_algorithms(True)
    try:
        return step(params, opt, microbatch(batch, k))
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_sharded_train_step_matches_unsharded(groups, case):
    name = case[0]
    qwen2 = case[1] == "qwen2-0.5b"
    params, _, m = _unsharded(case, groups["qwen2_params"] if qwen2 else None)
    got = groups["2x2"]
    for r in got:
        assert r[name]["bad"] == 0, (name, r["rank"])
        np.testing.assert_allclose(r[name]["loss"], float(m["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[name]["grad_norm"], float(m["grad_norm"]), rtol=LOSS_RTOL)
        assert r[name]["lr"] == float(m["lr"])
        assert r[name]["loss"] == got[0][name]["loss"]
    full = torch.load(groups["dir"] / f"{name}.pt")
    for a, b in zip(full, tree_leaves(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_qwen2_step_matches_reference(groups, k):
    """Both policies' sharded step against the reference's unsharded
    ``train_step`` from the same parameters: the bounds of
    ``tests/test_torch_train.py``."""
    jcfg, cfg = _qwen2()
    jinit, jstep = jax_make_train_fns(jcfg, JaxTrainRuntime(
        microbatches=k, adamw=JaxAdamWConfig(**ADAMW)))
    jparams, jopt = jinit(jax.random.key(0))
    batch = {n: jnp.asarray(v, jnp.int32) for n, v in _batch(cfg, 10).items()}
    if k > 1:
        batch = {n: x.reshape(k, B // k, *x.shape[1:]) for n, x in batch.items()}
    jparams, jopt, jm = jax.jit(jstep)(jparams, jopt, batch)
    want = tree_leaves(params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    for policy in ("tp", "dp"):
        name = f"qwen2_{policy}_k{k}"
        r = groups["2x2"][0][name]
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(r[key], float(jm[key]), rtol=1e-5, atol=1e-6)
        full = torch.load(groups["dir"] / f"{name}.pt")
        for a, b in zip(full, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL)


def test_context_parallel_step_on_a_three_way_axis(groups):
    """(1, 3): 4 heads on a 3-way model axis -> the query rows split (S =
    12); the step still equals the unsharded one."""
    case = TRAIN_CASES[0]
    params, _, m = _unsharded(case, groups["qwen2_params"])
    for r in groups["1x3"]:
        assert r["qwen2_cp"]["bad"] == 0
        np.testing.assert_allclose(r["qwen2_cp"]["loss"], float(m["loss"]), rtol=LOSS_RTOL)
    full = torch.load(groups["dir"] / "qwen2_cp.pt")
    for a, b in zip(full, tree_leaves(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("mesh", ["2x2", "1x3"])
def test_sharded_prefill_and_decode_match_unsharded(groups, mesh):
    for r in groups[mesh]:
        s = r["serve"]
        assert s["prefill"] <= SERVE_ATOL and s["decode"] <= SERVE_ATOL
        assert s["state"] <= SERVE_ATOL
        # Hkv 1 does not divide the model axis: the cache's W is split.
        assert s["w_split"]


def test_one_rank_mesh_is_bit_for_bit_unsharded(groups):
    """On a (1, 1) mesh every placement is trivial, and the sharded steps
    compute the unsharded ones' bits (deterministic algorithms)."""
    r = groups["1x1"][0]
    for name, case in (("one_tp", TRAIN_CASES[0]), ("one_granite", TRAIN_CASES[4])):
        params, _, m = _unsharded(case, groups["qwen2_params"] if "qwen2" in case[0] else None)
        assert r[name]["loss"] == float(m["loss"]) and r[name]["grad_norm"] == float(
            m["grad_norm"])
        for a, b in zip(torch.load(groups["dir"] / f"{name}.pt"), tree_leaves(params)):
            assert torch.equal(a, b)
    s = r["one_serve"]
    assert s["prefill"] == s["decode"] == s["state"] == 0.0 and not s["w_split"]


GRAPH_CASES = [c for c in TRAIN_CASES if c[1] == "qwen2-0.5b"]


@pytest.mark.parametrize("case", GRAPH_CASES, ids=[c[0] for c in GRAPH_CASES])
def test_graph_sharded_train_step_matches_eager(groups, case):
    """``graph_train_step`` (eager on its static buffers here) from the
    eager ``ShardedStep``'s start on the (2, 2) group, both policies,
    microbatches 1 and 2: the file's bounds against the eager step and
    the unsharded one; the leaves written in place; a batch of another
    layout refused by its leaf's name; ``load`` of the start and a step
    again equal to the first step."""
    name = case[0]
    params, _, m = _unsharded(case, groups["qwen2_params"])
    for r in groups["2x2"]:
        g = r[name]
        assert g["graph_diff"] <= PARAM_ATOL, (name, r["rank"], g["graph_diff"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g["graph"][key], r[name][key], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["graph"][key], float(m[key]), rtol=LOSS_RTOL)
        assert g["graph"]["lr"] == float(m["lr"])
        assert g["in_place"] and g["load_in_place"]
        assert g["load_unequal"] == 0
        assert "'labels'" in g["refused"], g["refused"]
    full = torch.load(groups["dir"] / f"{name}_graph.pt")
    for a, b in zip(full, tree_leaves(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("k", [1, 2])
def test_graph_sharded_qwen2_step_matches_reference(groups, k):
    """The graph step of both policies, from the reference's parameters
    (``params_from_reference``), against the reference's ``train_step``:
    the bounds of ``tests/test_torch_train.py``."""
    jcfg, cfg = _qwen2()
    jinit, jstep = jax_make_train_fns(jcfg, JaxTrainRuntime(
        microbatches=k, adamw=JaxAdamWConfig(**ADAMW)))
    jparams, jopt = jinit(jax.random.key(0))
    batch = {n: jnp.asarray(v, jnp.int32) for n, v in _batch(cfg, 10).items()}
    if k > 1:
        batch = {n: x.reshape(k, B // k, *x.shape[1:]) for n, x in batch.items()}
    jparams, jopt, jm = jax.jit(jstep)(jparams, jopt, batch)
    want = tree_leaves(params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    for policy in ("tp", "dp"):
        name = f"qwen2_{policy}_k{k}"
        r = groups["2x2"][0][name]["graph"]
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(r[key], float(jm[key]), rtol=1e-5, atol=1e-6)
        full = torch.load(groups["dir"] / f"{name}_graph.pt")
        for a, b in zip(full, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL)


def test_graph_sharded_steps_bit_for_bit_on_one_rank(groups):
    """On the (1, 1) group the graph train step equals the eager sharded
    step, and so the unsharded one, bit for bit; the graph prefill and
    decode steps equal ``lm.prefill`` / ``lm.decode_step`` bit for bit."""
    r = groups["1x1"][0]
    g = r["one_tp"]
    assert g["graph_unequal"] == 0 and g["graph_metrics_equal"] and g["in_place"]
    params, _, _ = _unsharded(TRAIN_CASES[0], groups["qwen2_params"])
    for a, b in zip(torch.load(groups["dir"] / "one_tp_graph.pt"), tree_leaves(params)):
        assert torch.equal(a, b)
    s = r["one_serve"]
    assert s["graph_prefill"] == s["graph_decode"] == s["graph_state"] == 0.0
    assert s["graph_in_place"]


@pytest.mark.parametrize("mesh", ["2x2", "1x3"])
def test_graph_prefill_and_decode_match_unsharded(groups, mesh):
    """``graph_prefill_step`` and ``graph_decode_step`` (the decode state
    donated: written in place) against ``lm.prefill`` / ``lm.decode_step``
    within 1e-5, the cache's W split on the model axis."""
    for r in groups[mesh]:
        s = r["serve"]
        assert s["graph_prefill"] <= SERVE_ATOL and s["graph_decode"] <= SERVE_ATOL
        assert s["graph_state"] <= SERVE_ATOL
        assert s["graph_in_place"]


def test_graph_context_parallel_step(groups):
    """The graph step on the (1, 3) group's context-parallel route equals
    the eager sharded step within the file's bounds."""
    for r in groups["1x3"]:
        g = r["qwen2_cp"]
        assert g["graph_diff"] <= PARAM_ATOL and g["load_unequal"] == 0 and g["in_place"]
        np.testing.assert_allclose(g["graph"]["loss"], r["qwen2_cp"]["loss"], rtol=LOSS_RTOL)


def test_sharded_trainer_trains_through_the_graph(groups):
    """``launch.train.make_sharded_trainer`` on a one-rank gloo group: its
    step is a ``GraphShardedStep``, 3 steps equal the one-process trainer's
    bit for bit (metrics and state), and a restart through disk
    (``Trainer.restore``, which copies into the placed leaves by ``load``)
    continues bit for bit."""
    t = groups["1x1"][0]["trainer"]
    assert t["step_type"] == "GraphShardedStep"
    assert t["metrics_equal"] and t["state_unequal"] == 0
    assert t["start"] == 3 and t["resumed"]


def test_flash_wrapper_takes_local_shards_through_local_map():
    """Without a group: the placements the kernel is given (whole GQA
    groups, batch splits, never a sequence split) as a pure function of the
    input placements and sizes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.flash_attention import ops

    class _T:
        def __init__(self, shape, placements, sizes):
            self.shape, self.placements = shape, placements
            self.device_mesh = type("M", (), {"shape": sizes})()

    q = _T((4, 14, 64, 64), [Shard(0), Shard(1)], (2, 16))
    k = _T((4, 2, 64, 64), [Shard(0), Replicate()], (2, 16))
    assert ops.kernel_placements(q, k) == [Shard(0), Replicate()]
    q = _T((4, 16, 64, 64), [Shard(0), Shard(1)], (2, 4))
    k = _T((4, 4, 64, 64), [Shard(0), Shard(1)], (2, 4))
    assert ops.kernel_placements(q, k) == [Shard(0), Shard(1)]
    q = _T((4, 16, 64, 64), [Replicate(), Shard(2)], (2, 4))
    assert ops.kernel_placements(q, k) == [Replicate(), Replicate()]
    assert callable(build_model) and callable(training_config)
