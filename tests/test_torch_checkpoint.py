"""The port's checkpoints on disk: the tree format, the sampler's JSON, and
the ensemble runner's chain restart through disk.

``repro_torch.checkpoint`` writes the reference's format (an ``.npz`` of
``/``-joined leaf paths plus ``<path>.meta.json``), so files cross between
the packages in both directions bit for bit.  ``repro_torch.core.checkpoint``
is the reference's sampler checkpoint with its imports repointed; its JSON
crosses too.  Then the reference's ``tests/test_ensemble.py`` auto-resume
tests on the port, with ``checkpoint_dir`` now taking effect.
"""
import json
import os
import threading
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
import repro_torch.checkpoint as ckpt
from repro.core import AdaptiveMetropolis as JaxAdaptiveMetropolis
from repro.core import MLDASampler as JaxMLDASampler
from repro.core.checkpoint import load_sampler as jax_load_sampler
from repro.core.checkpoint import save_sampler as jax_save_sampler
from repro_torch.balancer import BatchServer, LoadBalancer, Server
from repro_torch.core import AdaptiveMetropolis, GaussianRandomWalk, MLDASampler, balanced_mlda
from repro_torch.core.checkpoint import load_sampler, save_sampler
from repro_torch.ensemble import EnsembleRunner

Pair = namedtuple("Pair", "left right")


def _tree(rng, tensors: bool):
    wrap = torch.from_numpy if tensors else (lambda a: a)
    return {
        "w": wrap(rng.normal(size=(3, 4))),  # float64
        "layers": [
            {"b": wrap(rng.normal(size=5).astype(np.float32)),
             "idx": wrap(rng.integers(-9, 9, size=(2, 2)).astype(np.int64))},
            (wrap(rng.integers(0, 255, size=7).astype(np.int32)), None),
        ],
        "pair": Pair(wrap(np.float32(1.5) * np.ones(2, np.float32)), wrap(np.arange(3))),
    }


def _leaves(tree):
    return [leaf for _key, leaf in ckpt.checkpoint._leaves(tree)]


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(a, b) -> bool:
    a, b = _as_numpy(a), _as_numpy(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tensors", [True, False])
def test_roundtrip_bit_for_bit(tmp_path, tensors):
    tree = _tree(np.random.default_rng(0), tensors)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, tree, step=3, extra={"note": "x"})
    got, step, extra = ckpt.restore(path, tree)
    assert step == 3 and extra == {"note": "x"}
    assert got["layers"][1][1] is None and isinstance(got["pair"], Pair)
    assert len(_leaves(got)) == len(_leaves(tree)) == 6
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert isinstance(b, torch.Tensor) == tensors
        assert _bits_equal(a, b)


def test_reference_file_restores_in_port(tmp_path):
    """repro.checkpoint.save -> repro_torch.checkpoint.restore, bit for bit."""
    tree = _tree(np.random.default_rng(1), tensors=False)
    path = str(tmp_path / "ref.npz")
    jax_ckpt.save(path, tree, step=7, extra={"rng_state": {"state": 2**100 + 3}})
    like = _tree(np.random.default_rng(2), tensors=True)
    got, step, extra = ckpt.restore(path, like)
    assert step == 7 and extra == {"rng_state": {"state": 2**100 + 3}}
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert _bits_equal(a, b)


def test_port_file_restores_in_reference(tmp_path):
    """repro_torch.checkpoint.save -> repro.checkpoint.restore, bit for bit,
    the manifest included."""
    tree = _tree(np.random.default_rng(3), tensors=True)
    path = str(tmp_path / "port.npz")
    ckpt.save(path, tree, step=11, extra={"k": [1, 2]})
    ref_path = str(tmp_path / "ref.npz")
    jax_ckpt.save(ref_path, _tree(np.random.default_rng(3), tensors=False), step=11,
                  extra={"k": [1, 2]})
    with open(path + ".meta.json") as f, open(ref_path + ".meta.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
    like = _tree(np.random.default_rng(4), tensors=False)
    got, step, extra = jax_ckpt.restore(path, like)
    assert step == 11 and extra == {"k": [1, 2]}
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert _bits_equal(a, np.asarray(b))


def test_atomic_no_partial_file(tmp_path):
    """A save always goes tmp -> os.replace: no temp file stays behind, and
    a save that fails leaves the previous checkpoint whole."""
    tree = _tree(np.random.default_rng(5), tensors=True)
    path = str(tmp_path / "atomic.npz")
    ckpt.save(path, tree, step=1)
    ckpt.save(path, tree, step=2)
    _, step, _ = ckpt.restore(path, tree)
    assert step == 2
    # A dtype numpy cannot hold fails the save (bfloat16, which raised here
    # before training was ported, is written as raw 2-byte words now).
    bad = {"w": torch.zeros(2, dtype=torch.float8_e4m3fn)}
    with pytest.raises(TypeError, match="no numpy counterpart"):
        ckpt.save(path, bad, step=3)
    got, step, _ = ckpt.restore(path, tree)
    assert step == 2 and _bits_equal(got["w"], tree["w"])
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_async_checkpointer_latest_wins(tmp_path):
    """The host copy is taken at save(): a later in-place write to the tensor
    does not reach the file; of two saves to one path the later one stays."""
    x = torch.arange(6, dtype=torch.float32)
    path = str(tmp_path / "async.npz")
    ck = ckpt.AsyncCheckpointer()
    ck.save(path, {"x": x}, step=1)
    x.add_(100.0)
    ck.wait()
    got, step, _ = ckpt.restore(path, {"x": x})
    assert step == 1 and torch.equal(got["x"], torch.arange(6, dtype=torch.float32))
    ck.save(path, {"x": x}, step=2)
    ck.save(path, {"x": x * 2}, step=3)
    ck.wait()
    got, step, _ = ckpt.restore(path, {"x": x})
    assert step == 3 and torch.equal(got["x"], x * 2)
    assert os.path.exists(path + ".meta.json")


def test_restore_onto_device_and_dtype(tmp_path):
    path = str(tmp_path / "dev.npz")
    ckpt.save(path, {"a": np.arange(4, dtype=np.float64), "b": np.ones(2)}, step=0)
    like = {"a": torch.zeros(4, dtype=torch.float32), "b": np.zeros(2, np.float16)}
    got, _, _ = ckpt.restore(path, like, device="cpu")
    assert got["a"].device == torch.device("cpu") and got["a"].dtype == torch.float32
    assert torch.equal(got["a"], torch.arange(4, dtype=torch.float32))
    assert isinstance(got["b"], np.ndarray) and got["b"].dtype == np.float16
    got, _, _ = ckpt.restore(path, {"a": torch.empty(4, device="meta"), "b": None})
    assert got["a"].device == torch.device("cpu") and got["b"] is None
    # Onto bfloat16 (refused before training was ported): PyTorch's rounding
    # of the stored numbers; onto float8, refused.
    got, _, _ = ckpt.restore(path, {"a": torch.zeros(4, dtype=torch.bfloat16), "b": None})
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], torch.arange(4, dtype=torch.float64).to(torch.bfloat16))
    with pytest.raises(TypeError, match="no numpy counterpart"):
        ckpt.restore(path, {"a": torch.zeros(4, dtype=torch.float8_e4m3fn), "b": None})


# ---------------------------------------------------------------------------
# the sampler's JSON checkpoint, across the packages
# ---------------------------------------------------------------------------
def coarse(t):
    return float(-0.6 * np.sum((np.asarray(t) - 0.5) ** 2))


def fine(t):
    return float(-0.5 * np.sum(np.asarray(t) ** 2))


def _proposal(pkg):
    cls = JaxAdaptiveMetropolis if pkg == "ref" else AdaptiveMetropolis
    return cls(dim=2, adapt_start=10)


def _sampler(pkg):
    cls = JaxMLDASampler if pkg == "ref" else MLDASampler
    return cls([coarse, fine], _proposal(pkg), [3], speculative=True)


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_sampler_json_crosses_packages(tmp_path, src, dst):
    save = {"ref": jax_save_sampler, "port": save_sampler}[src]
    load = {"ref": jax_load_sampler, "port": load_sampler}[dst]
    rng = np.random.default_rng(8)
    s = _sampler(src)
    chain = s.sample(np.zeros(2), 40, rng)
    path = str(tmp_path / "sampler.json")
    save(path, s, rng, theta=chain[-1], step=40, extra={"who": src})
    s2 = _sampler(dst)
    info = load(path, s2)
    assert info["step"] == 40 and info["extra"] == {"who": src}
    assert np.array_equal(info["theta"], chain[-1])
    assert s2.proposal.state() == s.proposal.state()
    assert (s2.n_speculated, s2.n_spec_hits) == (s.n_speculated, s.n_spec_hits)
    for a, b in zip(s.levels, s2.levels):
        assert (a.n_evals, a.n_accepted, a.n_proposed, a.n_spec_discarded) == (
            b.n_evals, b.n_accepted, b.n_proposed, b.n_spec_discarded)
        assert a.eval_seconds == b.eval_seconds
        assert np.array_equal(np.asarray(a.samples), np.asarray(b.samples))
    assert info["rng"].bit_generator.state == rng.bit_generator.state
    assert np.array_equal(info["rng"].standard_normal(3), rng.standard_normal(3))


def test_save_sampler_records_the_balancer_queue(tmp_path):
    """``pending_queue`` is the port balancer's ``checkpoint_queue()``: with
    the one server held busy, the requests behind it are listed."""
    gate = threading.Event()
    lb = LoadBalancer([Server(lambda t: (gate.wait(5), float(np.sum(t)))[1], name="s",
                              capacity_tags=("level1",))])
    try:
        reqs = [lb.submit_async(np.full(2, float(i)), tag="level1") for i in range(3)]
        deadline = time.monotonic() + 5
        while len(lb.checkpoint_queue()) != 2 and time.monotonic() < deadline:
            time.sleep(0.001)  # until the first request is on the server
        s = _sampler("port")
        rng = np.random.default_rng(0)
        path = str(tmp_path / "queue.json")
        save_sampler(path, s, rng, theta=np.zeros(2), step=0, balancer=lb)
        info = load_sampler(path, _sampler("port"))
        queued = [tuple(q["theta"]) for q in info["pending_queue"]]
        assert [q["tag"] for q in info["pending_queue"]] == ["level1"] * 2
        assert queued == [(1.0, 1.0), (2.0, 2.0)]
    finally:
        gate.set()
        for r in reqs:
            r.done.wait(5)
        lb.shutdown()


# ---------------------------------------------------------------------------
# the ensemble runner's restart (the reference's tests/test_ensemble.py)
# ---------------------------------------------------------------------------
def crash_once_factory(crash_after):
    """Sampler factory whose FIRST incarnation dies after ``crash_after``
    fine evals; every later incarnation (the auto-resume rebuild) is
    healthy — a transient node loss."""
    armed = {"yes": True}

    def factory(c):
        calls = {"n": 0}
        this_one_crashes = armed["yes"]

        def flaky_fine(t):
            calls["n"] += 1
            if this_one_crashes and calls["n"] > crash_after:
                armed["yes"] = False
                raise RuntimeError("transient node loss")
            return fine(t)

        return MLDASampler([coarse, flaky_fine], GaussianRandomWalk(1.0), [2])

    return factory


def _clean(n_samples=30, n_chains=1, seed=0):
    return EnsembleRunner(
        lambda c: MLDASampler([coarse, fine], GaussianRandomWalk(1.0), [2]),
        n_chains, seed=seed,
    ).run(np.zeros(2), n_samples)


def test_auto_resume_restarts_chain_from_snapshot():
    runner = EnsembleRunner(
        crash_once_factory(12), 1, seed=0, max_restarts=1, checkpoint_every=5
    )
    res = runner.run(np.zeros(2), 30)
    assert res.chains.shape == (1, 30, 2)
    assert res.failures == {}
    assert res.restarts == {0: 1}
    # Samples secured before the last pre-crash snapshot are preserved
    # verbatim: they match the uninterrupted run bit for bit.
    assert np.array_equal(res.chains[0][:5], _clean().chains[0][:5])


def test_auto_resume_budget_exhausted_fails_chain():
    def factory(c):
        calls = {"n": 0}

        def fine_for(t):
            if c == 1:
                calls["n"] += 1
                if calls["n"] > 3:
                    raise RuntimeError("node keeps dying")
            return fine(t)

        return MLDASampler([coarse, fine_for], GaussianRandomWalk(1.0), [2])

    runner = EnsembleRunner(factory, 2, seed=3, max_restarts=2)
    res = runner.run(np.zeros(2), 25)
    assert set(res.failures) == {1}
    assert res.restarts == {1: 2}  # budget consumed before giving up
    assert res.chains.shape == (1, 25, 2)  # the healthy chain finished


def _count_restores(monkeypatch):
    """Record ``(file name, step)`` of every ``repro_torch.checkpoint.restore``
    (a file that does not load records step None)."""
    calls = []
    real = ckpt.restore

    def counting(path, like, **kw):
        calls.append([os.path.basename(path), None])
        out = real(path, like, **kw)
        calls[-1][1] = out[1]
        return out

    monkeypatch.setattr(ckpt, "restore", counting)
    return calls


def test_auto_resume_recovers_through_disk_checkpoint(tmp_path, monkeypatch):
    restores = _count_restores(monkeypatch)
    runner = EnsembleRunner(
        crash_once_factory(12), 1, seed=0, max_restarts=1, checkpoint_every=5,
        checkpoint_dir=str(tmp_path),
    )
    res = runner.run(np.zeros(2), 30)
    assert res.chains.shape == (1, 30, 2)
    assert res.restarts == {0: 1}
    assert (tmp_path / "chain_0.npz").exists()  # the snapshot really landed
    # The restart read the snapshot back from disk (inline densities never
    # park, so the runner snapshots a chain only at its start here; the
    # balancer-driven test below restarts from a later one).
    assert restores == [["chain_0.npz", 0]]
    tree, step, extra = ckpt.restore(str(tmp_path / "chain_0.npz"),
                                     {"theta": np.zeros(2), "samples": np.zeros((0, 2))})
    assert step == len(tree["samples"]) and "rng_state" in extra
    assert np.array_equal(res.chains[0][:5], _clean().chains[0][:5])


def test_unreadable_snapshot_falls_back_to_memory(tmp_path, monkeypatch):
    """A snapshot file that cannot be read (disk loss) does not fail the
    chain: the in-memory snapshot carries the restart."""
    restores = _count_restores(monkeypatch)
    real_save = ckpt.save

    def save_then_corrupt(path, tree, **kw):
        real_save(path, tree, **kw)
        with open(path, "wb") as f:
            f.write(b"not a zip")

    monkeypatch.setattr(ckpt, "save", save_then_corrupt)
    runner = EnsembleRunner(
        crash_once_factory(12), 1, seed=0, max_restarts=1, checkpoint_every=5,
        checkpoint_dir=str(tmp_path),
    )
    res = runner.run(np.zeros(2), 30)
    assert res.restarts == {0: 1} and res.failures == {}
    assert restores == [["chain_0.npz", None]]
    assert np.array_equal(res.chains[0][:5], _clean().chains[0][:5])


def test_balanced_mlda_restarts_a_chain_through_disk(tmp_path, monkeypatch):
    """``balanced_mlda(checkpoint_dir=...)`` end to end through the balancer,
    as chip_smoke's phase 4d drives it on the card: one NaN fine result on a
    ``check_finite`` pool fails one chain once; it resumes from its
    ``chain_<c>.npz``, its samples before the snapshot equal a clean run's,
    and the other chains equal the clean run entirely.  The NaN comes after
    about 20 fine evaluations a chain, past each chain's first snapshot."""
    n_chains, n_samples, every = 3, 30, 10

    def run(fault_after, checkpoint_dir):
        calls = {"n": 0}

        def fine_batch(ts):
            calls["n"] += len(ts)
            out = np.array([-0.5 * np.sum(t * t) for t in ts])[:, None]
            if fault_after is not None and calls["n"] > fault_after:
                fault_after_hit.append(calls["n"])
                out[0] = np.nan
                calls["n"] = -10**9  # once
            return out

        fault_after_hit = []
        servers = [
            BatchServer(lambda ts: -0.7 * np.sum((ts - 0.3) ** 2, axis=1)[:, None],
                        name="l0", capacity_tags=("level0",), max_batch=8),
            BatchServer(lambda ts: -0.6 * np.sum((ts - 0.5) ** 2, axis=1)[:, None],
                        name="l1", capacity_tags=("level1",), max_batch=8),
            BatchServer(fine_batch, name="l2", capacity_tags=("level2",), max_batch=8,
                        check_finite=True),
        ]
        runner, lb = balanced_mlda(
            servers, lambda obs: float(np.asarray(obs)[0]), lambda t: 0.0,
            GaussianRandomWalk(1.0), [3, 2], batchable_levels=(0, 1, 2), n_chains=n_chains,
            ensemble_seed=5, as_runner=True, max_restarts=1, checkpoint_every=every,
            checkpoint_dir=checkpoint_dir, batch_window_s=0.001,
        )
        try:
            return runner.run(np.zeros(2), n_samples), fault_after_hit
        finally:
            lb.shutdown()

    clean, _ = run(None, None)
    restores = _count_restores(monkeypatch)
    res, hit = run(20 * n_chains, str(tmp_path))
    assert hit and len(res.restarts) == 1
    (c, n), = res.restarts.items()
    assert n == 1 and res.failures == {}
    assert len(restores) == 1 and restores[0][0] == f"chain_{c}.npz"
    snap = restores[0][1]
    assert snap >= every and snap % every == 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        name for i in range(n_chains) for name in (f"chain_{i}.npz", f"chain_{i}.npz.meta.json"))
    assert np.isfinite(res.chains).all() and res.chains.shape == (n_chains, n_samples, 2)
    assert np.array_equal(res.chains[c][:snap], clean.chains[c][:snap])
    for other in set(range(n_chains)) - {c}:
        assert np.array_equal(res.chains[other], clean.chains[other])
