"""The port's training path against the JAX reference's, on the CPU.

Every reference arch, reduced (fp32), with ``attn_impl="chunked"`` in both
packages: the reference's parameters carried across with
``params_from_reference``, the same numpy batch through both, and
``bundle.loss`` with its autograd gradients against
``jax.value_and_grad`` of the reference's loss (the MoE aux loss, the VLM's
label slice and the encoder-decoder included).  Bounds: the loss within
1e-5, each gradient leaf within 1e-4 of the leaf's largest reference value
(two fp32 libraries summing in other orders; measured at most 8.5e-6,
mamba2).  Then ``make_train_fns`` for three steps against the reference's
``train_step`` (microbatches 1 and 2; parameters within 1e-6), remat on
against off bit for bit, the differentiable ``matmul_f32``, training's
attention, the launcher, and the train state through the checkpoint files:
the reference's resume test rerun on the port, and bf16 leaves bit for
bit, also from a file the reference wrote.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
import repro_torch.checkpoint as ckpt
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.runtime.train_loop import TrainRuntime as JaxTrainRuntime
from repro.runtime.train_loop import make_train_fns as jax_make_train_fns
from repro_torch.configs import ARCHS, ShapeConfig, arch_from_reference
from repro_torch.data import microbatch, synthetic_lm_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, layers, params_from_reference
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.optim.tree import tree_leaves, tree_map, value_and_grad
from repro_torch.runtime import train_loop
from repro_torch.runtime.train_loop import TrainRuntime, make_grad_fn, make_train_fns

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4  # of each leaf's largest reference value
# Three AdamW steps at lr 1e-3 with eps 1e-3 in both packages: the update
# lr m_hat / (sqrt(v_hat) + eps) then moves by at most lr / eps times a
# gradient entry's difference (~1e-6 relative between the libraries).  At
# the default eps 1e-8 an entry within ~1e-8 of zero turns that difference
# into a whole update (measured: one element of 16,384 off by 4e-5).
ADAM_EPS = 1e-3
PARAM_ATOL = 1e-6
B, S = 2, 16


def _batch(cfg, seed=1):
    """Numpy batch of the cell (B, S): tokens, labels and the family's
    frames or patches."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_leaves_close(got, want, rtol):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        bound = rtol * max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= bound


def _reference(name, **changes):
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), attn_impl="chunked", **changes)
    return jcfg, arch_from_reference(jcfg)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_loss_and_gradients_match_reference(name):
    jcfg, cfg = _reference(name)
    jbundle = jax_build_model(jcfg)
    jparams = jbundle.init(jax.random.key(0))
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jbundle.loss))(jparams, _jax_batch(batch))
    params = params_from_reference(_np(jparams), cfg, "cpu")
    loss, grads = value_and_grad(build_model(cfg).loss, params, _torch_batch(batch))
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    want = params_from_reference(_np(jgrads), cfg, "cpu")
    assert len(tree_leaves(grads)) == len(tree_leaves(want))
    _assert_leaves_close(grads, want, GRAD_RTOL)


def _state_from_reference(state, cfg):
    return AdamWState(
        step=torch.tensor(int(state.step), dtype=torch.int32),
        m=params_from_reference(_np(state.m), cfg, "cpu"),
        v=params_from_reference(_np(state.v), cfg, "cpu"),
        master=None if state.master is None else params_from_reference(_np(state.master), cfg,
                                                                        "cpu"),
    )


@pytest.mark.parametrize("name,k", [("smollm-360m", 1), ("smollm-360m", 2),
                                    ("granite-moe-3b-a800m", 2)])
def test_train_steps_match_reference(name, k):
    """Three train steps from the reference's initial params and AdamW
    state (carried across), on the same numpy batches: loss, lr and grad
    norm each step, and the params, moments and step count after."""
    jcfg, cfg = _reference(name)
    adamw = dict(lr=1e-3, eps=ADAM_EPS, warmup_steps=2, total_steps=20)
    jinit, jstep = jax_make_train_fns(jcfg, JaxTrainRuntime(microbatches=k,
                                                             adamw=JaxAdamWConfig(**adamw)))
    _, step = make_train_fns(cfg, TrainRuntime(microbatches=k, adamw=AdamWConfig(**adamw)))
    jparams, jopt = jinit(jax.random.key(0))
    params = params_from_reference(_np(jparams), cfg, "cpu")
    opt = _state_from_reference(jopt, cfg)
    jstep = jax.jit(jstep)
    for s in range(3):
        batch = _batch(cfg, seed=10 + s)
        jb = {n: x.reshape(k, B // k, *x.shape[1:]) if k > 1 else x
              for n, x in _jax_batch(batch).items()}
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        params, opt, m = step(params, opt, microbatch(_torch_batch(batch), k))
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    assert int(opt.step) == int(jopt.step) == 3
    want = params_from_reference(_np(jparams), cfg, "cpu")
    for g, w in zip(tree_leaves(params), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL)
    for tree, jtree in ((opt.m, jopt.m), (opt.v, jopt.v)):
        _assert_leaves_close(tree, params_from_reference(_np(jtree), cfg, "cpu"), GRAD_RTOL)


@pytest.mark.parametrize("name", ["smollm-360m", "zamba2-1.2b", "whisper-large-v3",
                                  "granite-moe-3b-a800m"])
def test_remat_changes_no_bit(name):
    """Remat recomputes the same operations on the same values: loss and
    gradients equal bit for bit with it on and off (the hybrid's groups
    nest a checkpoint in a checkpoint; the encoder-decoder checkpoints
    both stacks).  Deterministic algorithms: the CPU's embedding backward
    accumulates rows in no fixed order otherwise."""
    _, cfg = _reference(name)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(cfg))
    torch.use_deterministic_algorithms(True)
    try:
        on = make_grad_fn(dataclasses.replace(cfg, remat=True), TrainRuntime())(params, batch)
        off = make_grad_fn(dataclasses.replace(cfg, remat=False), TrainRuntime())(params, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])):
        assert torch.equal(a, b)


def test_remat_recomputes_in_the_backward(monkeypatch):
    """Under remat each block runs again in the backward pass (and each
    key block of the chunked attention, as the reference's scan step);
    without a gradient it runs once."""
    from repro_torch.models import lm

    _, cfg = _reference("smollm-360m")
    cfg = dataclasses.replace(cfg, remat=True)
    calls = []
    real = lm._apply_attn_block
    monkeypatch.setattr(lm, "_apply_attn_block", lambda *a: calls.append(1) or real(*a))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(cfg))
    value_and_grad(build_model(cfg).loss, params, batch)
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    with torch.no_grad():
        build_model(cfg).loss(params, batch)
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("impl", ["kernel", "xla", "chunked"])
def test_training_takes_chunked_attention(monkeypatch, impl):
    """make_train_fns trains with the reference's training attention,
    whatever the config serves with (the flash kernel refuses autograd on
    the card)."""
    from repro_torch.models import attention

    seen = []
    real = attention.attn_op
    monkeypatch.setattr(attention, "attn_op", lambda *a, **kw: seen.append(kw["impl"])
                        or real(*a, **kw))
    _, cfg = _reference("qwen2-0.5b")
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    init, step = make_train_fns(cfg, TrainRuntime())
    params, opt = init(torch.Generator().manual_seed(0), "cpu")
    step(params, opt, _torch_batch(_batch(cfg)))
    assert seen and set(seen) == {"chunked"}
    assert train_loop.training_config(cfg).attn_impl == "chunked"


def test_matmul_f32_backward_is_the_upcast_backward():
    """The card's route (``MatmulF32`` over cuBLAS's out_dtype GEMM) forced
    on the CPU with the upcast as its product: output and both gradients
    equal autograd of ``a.float() @ b.float()`` bit for bit, in bf16 (the
    gradients cast back to bf16) and fp32, for (..., M, K) x (K, N) and the
    batched form."""
    upcast = lambda a, b: a.float() @ b.float()  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for a_shape, b_shape in (((2, 5, 8), (8, 6)), ((3, 5, 8), (3, 8, 6))):
            a = torch.randn(a_shape, generator=gen).to(dtype).requires_grad_()
            b = torch.randn(b_shape, generator=gen).to(dtype).requires_grad_()
            cot = torch.randn((*a_shape[:-1], b_shape[-1]), generator=gen)
            out = layers.MatmulF32.apply(a, b, upcast)
            got = torch.autograd.grad(out, (a, b), cot)
            ref = upcast(a, b)
            want = torch.autograd.grad(ref, (a, b), cot)
            assert out.dtype == torch.float32 and torch.equal(out, ref)
            for g, w in zip(got, want):
                assert g.dtype == dtype and torch.equal(g, w)
    # The CPU's own route is the upcast, differentiable as it is.
    a = torch.randn((4, 8), generator=gen).to(torch.bfloat16).requires_grad_()
    w = torch.randn((16, 8), generator=gen).to(torch.bfloat16).requires_grad_()
    layers.unembed(a, w).sum().backward()
    assert a.grad.dtype == w.grad.dtype == torch.bfloat16


def test_cross_entropy_matches_reference():
    """The gold logit by a gather where the reference contracts a one-hot:
    the same value, at logits far from 0."""
    from repro.models.layers import cross_entropy_loss as jax_ce

    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 5, 11)) * 30).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5))
    got = layers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(jax_ce(jnp.asarray(logits),
                                                        jnp.asarray(labels))), rtol=1e-6)


def test_runtimes_and_refusals():
    assert train_loop.get_runtime("nemotron-4-340b").microbatches == 4
    assert train_loop.get_runtime("smollm-360m") == TrainRuntime()
    from repro.runtime.train_loop import TRAIN_RUNTIMES as JAX_RUNTIMES

    assert sorted(train_loop.TRAIN_RUNTIMES) == sorted(JAX_RUNTIMES)
    for name, rt in JAX_RUNTIMES.items():
        mine = train_loop.TRAIN_RUNTIMES[name]
        assert (mine.microbatches, mine.grad_dtype) == (rt.microbatches, rt.grad_dtype)
        assert dataclasses.asdict(mine.adamw) == dataclasses.asdict(rt.adamw)
    # The sharded step is ported (item 10): it refuses what the reference's
    # refuses, a call without a config.
    from repro.runtime.train_loop import shard_train_step as jax_shard_train_step

    for fn in (train_loop.shard_train_step, jax_shard_train_step):
        with pytest.raises(AttributeError):
            fn(None, None, None)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """The CLI on the CPU prints the reference's log lines; a run stopped
    after 6 of 12 steps (its checkpoint written by the launcher's ``run``)
    and resumed by the CLI with ``--resume`` ends where a straight run
    does, bit for bit (deterministic algorithms: the CPU's embedding
    backward)."""
    straight_path, resumed_path = str(tmp_path / "straight.npz"), str(tmp_path / "resumed.npz")
    common = ["--reduced", "--device", "cpu", "--seq-len", "32", "--batch", "4", "--steps", "12"]
    torch.use_deterministic_algorithms(True)
    try:
        straight = launch_train.main(common + ["--checkpoint", straight_path, "--log-every", "4"])
        out = capsys.readouterr().out
        trainer = launch_train.make_trainer(ARCHS["smollm-360m"].reduced(), steps=12, seq_len=32,
                                            batch=4, device="cpu")
        launch_train.run(trainer, 0, 6, checkpoint=resumed_path, checkpoint_every=3)
        resumed = launch_train.main(common + ["--checkpoint", resumed_path, "--resume"])
    finally:
        torch.use_deterministic_algorithms(False)
    assert "[train] step 1/12 loss=" in out and "[train] step 12/12" in out and "tok/s=" in out
    assert "[train] resumed from step 6" in capsys.readouterr().out
    assert resumed == straight
    (a, step_a, _), (b, step_b, _) = (ckpt.restore(p, trainer.state)
                                      for p in (straight_path, resumed_path))
    assert step_a == step_b == 12
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the train state on disk
# ---------------------------------------------------------------------------
SHAPE = ShapeConfig("ck", seq_len=32, global_batch=4, kind="train")


def _setup():
    cfg = ARCHS["smollm-360m"].reduced()
    rt = TrainRuntime(adamw=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    init_fn, train_step = make_train_fns(cfg, rt)
    params, opt = init_fn(torch.Generator().manual_seed(0), "cpu")
    return cfg, train_step, params, opt


def test_resume_bit_identical_training(tmp_path):
    """The reference's ``tests/test_checkpoint.py`` test on the port: 6
    steps straight against 3 + save + restore + 3 give identical params
    (here bit for bit, under deterministic algorithms; the reference holds
    1e-6)."""
    cfg, step_fn, params, opt = _setup()
    batch = lambda s: synthetic_lm_batch(cfg, SHAPE, s, device="cpu")  # noqa: E731
    torch.use_deterministic_algorithms(True)
    try:
        p, o = params, opt
        for s in range(6):
            p, o, _ = step_fn(p, o, batch(s))
        p2, o2 = params, opt
        for s in range(3):
            p2, o2, _ = step_fn(p2, o2, batch(s))
        path = str(tmp_path / "mid.npz")
        ckpt.save(path, (p2, o2), step=3)
        (p3, o3), start, _ = ckpt.restore(path, (params, opt))
        for s in range(start, 6):
            p3, o3, _ = step_fn(p3, o3, batch(s))
    finally:
        torch.use_deterministic_algorithms(False)
    assert start == 3
    for a, b in zip(tree_leaves((p, o)), tree_leaves((p3, o3))):
        assert torch.equal(a, b)


def test_bf16_train_state_round_trips_bit_for_bit(tmp_path):
    """A bf16 train state (bf16 params and moments, an fp32 master copy,
    the int32 step) saved and restored with the same bits, also through the
    async checkpointer; the file holds the bf16 leaves as raw 2-byte words
    (``|V2``), as the reference writes them."""
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    rt = TrainRuntime(adamw=AdamWConfig(master_dtype="float32"))
    init_fn, step_fn = make_train_fns(cfg, rt)
    params, opt = init_fn(torch.Generator().manual_seed(0), "cpu")
    params, opt, _ = step_fn(params, opt, synthetic_lm_batch(cfg, SHAPE, 0, device="cpu"))
    state = (params, opt)
    for saver in (ckpt.save, ckpt.AsyncCheckpointer().save):
        path = str(tmp_path / f"bf16_{saver.__name__}.npz")
        saver(path, state, step=1)
        if not hasattr(saver, "__self__"):
            with np.load(path) as data:
                assert data["0/embed"].dtype == np.dtype("V2")
                assert data["1/.master/embed"].dtype == np.float32
        else:
            saver.__self__.wait()
        like = tree_map(torch.zeros_like, state)
        got, step, _ = ckpt.restore(path, like)
        assert step == 1
        leaves = tree_leaves(got)
        assert {t.dtype for t in leaves} == {torch.bfloat16, torch.float32, torch.int32}
        for a, b in zip(tree_leaves(state), leaves):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_bf16_file_restores_in_port(tmp_path):
    """A bf16 ``.npz`` that the reference's ``save`` writes restores in the
    port bit for bit (reinterpreted, then cast where the port's leaf is
    fp32).  The reference's own ``restore`` of the same file raises
    ``ValueError: No cast function available`` (its ``astype`` from the
    stored ``|V2`` words to bfloat16; ROADMAP Queue 3 note 6)."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(3, 4)).astype(ml_dtypes.bfloat16),
            "b": [rng.normal(size=5).astype(ml_dtypes.bfloat16), np.arange(3, dtype=np.int32)]}
    path = str(tmp_path / "ref_bf16.npz")
    jax_ckpt.save(path, tree, step=5)
    like = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
            "b": [torch.zeros(5, dtype=torch.float32), torch.zeros(3, dtype=torch.int32)]}
    got, step, _ = ckpt.restore(path, like)
    assert step == 5
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy(), tree["w"].view(np.int16))
    assert torch.equal(got["b"][0], torch.from_numpy(tree["b"][0].astype(np.float32)))
    assert torch.equal(got["b"][1], torch.arange(3, dtype=torch.int32))
    # And the port's bf16 file is the reference's bytes.
    mine = str(tmp_path / "port_bf16.npz")
    ckpt.save(mine, {"w": got["w"], "b": [got["b"][0].to(torch.bfloat16), got["b"][1]]}, step=5)
    with np.load(mine) as a, np.load(path) as b:
        assert a["w"].tobytes() == b["w"].tobytes() and a["b/0"].tobytes() == b["b/0"].tobytes()
