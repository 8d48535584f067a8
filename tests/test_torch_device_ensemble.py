"""The port's device-resident MLDA (``repro_torch.core.mlda_device``).

The contract ``tests/test_device_ensemble.py`` holds for the reference,
re-proved within the port: the fused ``(C,)``-wide ensemble equals ``C``
independent ``MLDASampler`` step machines driven by ``CounterStream`` and
``DeviceMatchedRandomWalk``, bit for bit in theta (float32) and equal in
per-level ``(accepted, proposed, evals)`` counts, for 1-, 2- and 3-level
hierarchies, across chunked ``advance`` calls, through the runner, and in
the coupled mode whose fine level sits behind a real balancer.  Then the
counter-mode draws (a chain's numbers do not depend on C or on where it
sits), ``run_chains`` against ``tests/test_mlda_jax.py``'s four targets with
its bounds, the prior's ``-inf`` outside the box, and the Tōhoku densities
on tiny grids against the JAX package's.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import fit_gp as jax_fit_gp
from repro.swe import TohokuScenario as JaxScenario
from repro.swe import make_hierarchy as jax_make_hierarchy
from repro_torch.balancer import Server
from repro_torch.core import (
    CounterStream,
    DeviceMatchedRandomWalk,
    GaussianRandomWalk,
    MLDASampler,
    balanced_mlda,
    chain_keys,
    make_device_ensemble,
    make_mlda_kernel,
    run_chains,
)
from repro_torch.core import counter_rng as crng
from repro_torch.core.diagnostics import gelman_rubin
from repro_torch.core.gp import gp_from_arrays
from repro_torch.ensemble import DeviceEnsembleRunner
from repro_torch.swe import TohokuScenario, device_densities, make_hierarchy

CPU = "cpu"
THETA0 = np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(3, 2)


def rowsum(x):
    """Sum over the last axis column by column: one order at every B."""
    out = x[:, 0]
    for j in range(1, x.shape[1]):
        out = out + x[:, j]
    return out


def lp0(t):
    r = t - 0.3
    return -0.7 * rowsum(r * r)


def lp1(t):
    return -0.5 * rowsum(t * t)


def lp2(t):
    r = t - 0.1
    return -0.45 * rowsum(r * r)


def host(lp):
    """Float-valued host twin: the same batched density at B = 1."""
    return lambda t: float(lp(torch.as_tensor(np.asarray(t, np.float32))[None])[0])


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def counts_of(stats):
    return [(r.n_accepted, r.n_proposed, r.n_evals) for r in stats.levels]


def host_chains(densities, subchains, scale, theta0, n, seed):
    keys = chain_keys(seed, theta0.shape[0])
    chains, counts = [], []
    for c in range(theta0.shape[0]):
        samp = MLDASampler(
            [host(lp) for lp in densities], DeviceMatchedRandomWalk(scale), list(subchains)
        )
        chain = samp.sample(theta0[c], n, CounterStream(keys[c]))
        chains.append(np.asarray(chain, np.float32))
        counts.append(counts_of(samp))
    return np.stack(chains), counts


def fused_chains(densities, subchains, scale, theta0, n, seed, chunk=None):
    ens = make_device_ensemble(densities, list(subchains), scale, device=CPU)
    state = ens.init(theta0, seed=seed)
    blocks, drawn = [], 0
    while drawn < n:
        k = n - drawn if chunk is None else min(chunk, n - drawn)
        state, thetas, _ = ens.advance(state, k)
        blocks.append(thetas.numpy())
        drawn += k
    counts = state.counts.numpy()
    return np.concatenate(blocks, axis=1), [
        [tuple(int(v) for v in counts[c, lvl]) for lvl in range(counts.shape[1])]
        for c in range(counts.shape[0])
    ]


HIERARCHIES = {
    "one-level": ([lp1], []),
    "two-level": ([lp0, lp1], [3]),
    "three-level": ([lp0, lp2, lp1], [3, 2]),
}


@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_fused_bit_identity(name):
    densities, subchains = HIERARCHIES[name]
    dev, dev_counts = fused_chains(densities, subchains, 0.8, THETA0, 25, seed=7)
    ref, ref_counts = host_chains(densities, subchains, 0.8, THETA0, 25, seed=7)
    assert np.array_equal(bits(dev), bits(ref))
    assert dev_counts == ref_counts


def test_chunked_advance_matches_single_launch():
    """Host syncs between chunks must not perturb the stream: resuming from
    a carried EnsembleState is the same chain as one long advance."""
    one, one_counts = fused_chains([lp0, lp1], [3], 0.8, THETA0, 24, seed=3)
    chunked, chunked_counts = fused_chains([lp0, lp1], [3], 0.8, THETA0, 24, seed=3, chunk=5)
    assert np.array_equal(bits(one), bits(chunked))
    assert one_counts == chunked_counts


def test_draw_table_covers_every_counter_a_step_consumes():
    """The per-step draw table's length is the most one step consumes: the
    counter never moves further in a step, and a step with every subchain
    at its longest reaches the bound."""
    ens = make_device_ensemble([lp0, lp2, lp1], [3, 2], 0.8, device=CPU)
    state = ens.init(np.zeros((16, 2), np.float32), seed=1)
    span, most = ens._step_span(), 0
    for _ in range(30):
        before = state.counter
        state, _, _ = ens.advance(state, 1)
        most = max(most, int((state.counter - before).max()))
    assert 0 < most <= span
    assert span == 1 + 3 * (1 + 2 * 5 + 1) + 1  # length, 3 x (length, 5 x 2, u), u


def test_runner_fused_mode_counts_and_chains():
    ens = make_device_ensemble([lp0, lp1], [3], 0.8, device=CPU)
    runner = DeviceEnsembleRunner(ens, seed=7, chunk=4)
    res = runner.run(THETA0, 25)
    ref, ref_counts = host_chains([lp0, lp1], [3], 0.8, THETA0, 25, seed=7)
    assert np.array_equal(bits(res.chains), bits(ref))
    for c in range(THETA0.shape[0]):
        assert counts_of(res.samplers[c]) == ref_counts[c]
    assert res.summary()["n_chains"] == THETA0.shape[0]
    assert runner.device_seconds > 0


def test_runner_rejects_per_chain_callable_theta0():
    runner = DeviceEnsembleRunner(make_device_ensemble([lp1], [], 0.8, device=CPU))
    with pytest.raises(TypeError):
        runner.run(lambda c, rng: np.zeros(2), 3)


def test_modes_refuse_the_other_modes_calls():
    fused = make_device_ensemble([lp1], [], 0.8, device=CPU)
    coupled = make_device_ensemble([lp1], [2], 0.8, remote_top=True, device=CPU)
    state = fused.init(THETA0)
    with pytest.raises(RuntimeError, match="coupled"):
        fused.propose(state)
    with pytest.raises(ValueError, match="logp0"):
        coupled.init(THETA0)
    with pytest.raises(RuntimeError, match="fully-fused"):
        coupled.advance(coupled.init(THETA0, logp0=np.zeros(3)), 1)
    with pytest.raises(ValueError, match="k must be"):
        fused.advance(state, 0)
    with pytest.raises(ValueError, match="one subchain length"):
        make_device_ensemble([lp0, lp1], [], 0.8, device=CPU)


def _coupled_run(densities, fine_fwd, log_lik, log_prior, subchains, theta0, n, **kw):
    runner, bal = balanced_mlda(
        [Server(fine_fwd, name="s0")], log_lik, log_prior,
        GaussianRandomWalk(scale=0.8), subchains, device_resident=True,
        device_densities=densities, ensemble_seed=0, device=CPU, **kw,
    )
    try:
        return runner.run(theta0, n)
    finally:
        bal.shutdown()


def test_coupled_through_balancer_bit_identity():
    """Fine level behind a real balancer Server: propose on the device,
    solve through the pool, accept on the device: still bit-identical, and
    the runner's LevelRecord totals match the step machine's."""

    def fwd(theta):
        return np.asarray(theta, np.float32)

    def log_lik(obs):
        return -0.5 * float(np.sum((np.asarray(obs) - 0.5) ** 2))

    def log_prior(t):
        return 0.0

    theta0 = np.asarray([[0.1, -0.2], [0.4, 0.0]], np.float32)
    res = _coupled_run([lp0], fwd, log_lik, log_prior, [3], theta0, 20)

    def fine(t):
        return log_prior(t) + log_lik(fwd(np.asarray(t, np.float32)))

    keys = chain_keys(0, 2)
    for c in range(2):
        samp = MLDASampler([host(lp0), fine], DeviceMatchedRandomWalk(0.8), [3])
        chain = samp.sample(theta0[c], 20, CounterStream(keys[c]))
        assert np.array_equal(bits(chain), bits(res.chains[c]))
        assert counts_of(samp) == counts_of(res.samplers[c])


def test_balanced_mlda_device_arg_validation():
    servers = [Server(lambda t: t, name="s0")]
    args = (servers, lambda o: 0.0, lambda t: 0.0, GaussianRandomWalk(0.5), [3])
    with pytest.raises(ValueError, match="device_densities"):  # missing densities
        balanced_mlda(*args, device_resident=True, device=CPU)
    with pytest.raises(ValueError, match="device_densities"):  # one too many
        balanced_mlda(*args, device_resident=True, device_densities=[lp0, lp1], device=CPU)
    with pytest.raises(ValueError, match="step-machine"):  # speculation
        balanced_mlda(*args, device_resident=True, device_densities=[lp0],
                      speculative=True, device=CPU)
    with pytest.raises(ValueError, match="step-machine"):  # hedging
        balanced_mlda(*args, device_resident=True, device_densities=[lp0],
                      hedged_levels=(1,), device=CPU)


def test_balanced_mlda_device_mode_returns_a_runner():
    runner, bal = balanced_mlda(
        [Server(lambda t: np.asarray(t), name="s0")], lambda o: 0.0, lambda t: 0.0,
        GaussianRandomWalk(0.5), [3], device_resident=True, device_densities=[lp0],
        device_chunk=7, ensemble_seed=4, device=CPU,
    )
    bal.shutdown()
    assert isinstance(runner, DeviceEnsembleRunner) and runner.balancer is bal
    assert runner.chunk == 7 and runner.seed == 4
    assert runner.ensemble.remote_top and runner.ensemble.n_levels == 2


# -- the prior's -inf: log_alpha as the reference's ---------------------------
def box(lp):
    """``lp`` inside [-1, 1]^2, -inf outside."""

    def boxed(t):
        inside = torch.all(t.abs() <= 1.0, dim=-1)
        return torch.where(inside, lp(t), -torch.inf)

    return boxed


def test_chains_that_propose_outside_the_box():
    """Candidates outside the box have density -inf: never accepted at
    level 0, and (-inf) - (-inf) is NaN, so a start outside the box stays
    put as the reference's does.  Fused == step machines throughout."""
    theta0 = np.asarray([[0.9, -0.95], [0.99, 0.99], [1.5, 0.0]], np.float32)
    densities = [box(lp0), box(lp1)]
    dev, dev_counts = fused_chains(densities, [3], 0.8, theta0, 20, seed=11)
    ref, ref_counts = host_chains(densities, [3], 0.8, theta0, 20, seed=11)
    assert np.array_equal(bits(dev), bits(ref)) and dev_counts == ref_counts
    assert np.all(np.abs(dev[:2]) <= 1.0)
    assert np.array_equal(dev[2], np.broadcast_to(theta0[2], dev[2].shape))
    assert dev_counts[0][0][1] > dev_counts[0][0][0]  # rejections at level 0 happened


# -- counter-mode draws ----------------------------------------------------------
def test_philox_known_answers():
    """Random123's known-answer vectors for Philox-4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        out = crng.philox4x32([torch.tensor([c]) for c in ctr], [torch.tensor([k]) for k in key])
        assert tuple(int(o) for o in out) == want


def _numbers(keys, counters, dim):
    words = crng.draw_words(keys, counters, dim)
    return (crng.normal_of(words), crng.log_uniform_of(words[..., 0]),
            crng.integers_of(words[..., 0], 1, 19))


@pytest.mark.parametrize("n_chains", [1, 5, 64])
def test_draws_do_not_depend_on_the_chain_count(n_chains):
    """A chain's numbers are the same bits whatever C is and wherever the
    chain sits (the rows are permuted here), at counters enough for the
    library's vectorised bodies and scalar tails alike."""
    keys = chain_keys(9, 64)
    counters = torch.arange(203, dtype=torch.int64)
    alone = _numbers(keys[:1], counters[None], 3)
    rows = torch.randperm(64, generator=torch.Generator().manual_seed(n_chains))[:n_chains]
    if 0 not in rows:
        rows[-1] = 0
    batch = _numbers(keys[rows], counters.expand(n_chains, -1).contiguous(), 3)
    at = int((rows == 0).nonzero()[0, 0])
    for a, b in zip(alone, batch):
        assert torch.equal(a[0], b[at])
    assert torch.equal(chain_keys(9, n_chains), keys[:n_chains])


def test_fused_chain_does_not_depend_on_the_chain_count():
    theta0 = np.random.default_rng(0).uniform(-1, 1, (64, 2)).astype(np.float32)
    alone, _ = fused_chains([lp0, lp1], [3], 0.8, theta0[:1], 12, seed=5)
    for n in (5, 64):
        many, _ = fused_chains([lp0, lp1], [3], 0.8, theta0[:n], 12, seed=5)
        assert np.array_equal(bits(alone[0]), bits(many[0]))


def test_counter_stream_is_the_table_and_numbers_are_sound():
    key = chain_keys(3, 4)[2]
    stream = CounterStream(key, counter=10)
    words = crng.draw_words(key[None], torch.arange(10, 13)[None], 2)[0]
    assert np.array_equal(stream.normal(size=2), crng.normal_of(words[0]).numpy())
    assert stream.uniform() == float(crng.uniform_of(words[1, :1])[0])
    assert stream.integers(1, 19) == int(crng.integers_of(words[2, 0], 1, 19))
    assert stream.counter == 13
    z = crng.normal_of(crng.draw_words(chain_keys(1, 1), torch.arange(20000)[None], 4))
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1.0) < 0.03
    y = torch.tensor([1e-300, 1e-8, 0.02425, 0.3, 1.0, 7.5], dtype=torch.float64)
    np.testing.assert_allclose(crng.log_f64(y).numpy(), np.log(y.numpy()), rtol=4e-16)
    assert crng.log_f64(torch.zeros(1, dtype=torch.float64))[0] == -np.inf


# -- run_chains: tests/test_mlda_jax.py's four targets, its bounds -----------------
def test_two_level_targets_fine():
    lpa = lambda t: -0.5 * rowsum((t - 0.3) ** 2)  # noqa: E731
    lpb = lambda t: -0.5 * rowsum(t**2)  # noqa: E731
    res = run_chains([lpa, lpb], [3], 1.0, 0, np.zeros((4, 2)), 1500, device=CPU)
    x = res.chain[:, 400:, :].reshape(-1, 2).numpy()
    assert np.all(np.abs(x.mean(0)) < 0.15)
    assert np.all(np.abs(x.var(0) - 1.0) < 0.25)


def test_three_level_counts_and_target():
    lpa = lambda t: -0.7 * rowsum((t - 0.4) ** 2)  # noqa: E731
    lpb = lambda t: -0.6 * rowsum((t - 0.2) ** 2)  # noqa: E731
    lpc = lambda t: -0.5 * rowsum(t**2)  # noqa: E731
    res = run_chains([lpa, lpb, lpc], [3, 2], 1.0, 1, np.zeros((2, 2)), 1200, device=CPU)
    x = res.chain[:, 300:, :].reshape(-1, 2).numpy()
    assert np.all(np.abs(x.mean(0)) < 0.25)
    acc, prop = res.accepts.numpy(), res.proposals.numpy()
    assert acc.shape == (2, 3) and prop.shape == (2, 3)
    assert np.all(acc <= prop)
    # coarse level proposes far more than the top level
    assert np.all(prop[:, 0] > prop[:, 2])


def test_multi_chain_convergence_rhat():
    lp = lambda t: -0.5 * rowsum(t**2)  # noqa: E731
    res = run_chains([lp], [], 1.2, 2, np.ones((4, 1)) * 3.0, 2500, device=CPU)
    assert gelman_rubin(res.chain[:, 500:, 0].numpy()) < 1.1


def test_kernel_is_deterministic():
    lpa = lambda t: -0.5 * rowsum((t - 0.1) ** 2)  # noqa: E731
    lpb = lambda t: -0.5 * rowsum(t**2)  # noqa: E731
    kern = make_mlda_kernel([lpa, lpb], [2], 0.8)
    a = kern(chain_keys(3, 1), torch.zeros(1, 2), 50)
    b = kern(chain_keys(3, 1), torch.zeros(1, 2), 50)
    assert torch.equal(a.chain, b.chain) and torch.equal(a.proposals, b.proposals)


# -- the Tōhoku densities on tiny grids ---------------------------------------------
GRIDS = dict(fine=24, coarse=16, t_end=1200.0)
OBS_ATOL = 2e-3  # the scenario observables' bound against JAX (test_torch_swe.py)
GP_ATOL = 1e-4  # gp_from_arrays' bound against JAX's predict (test_torch_gp.py)


@pytest.fixture(scope="module")
def tohoku():
    """Both frameworks' hierarchies at the same tiny grids, the port's
    problem on the reference's y_obs, and the port's GP made from the
    fields of the reference's (fitted on the reference's coarse solves)."""
    g = GRIDS
    jh = jax_make_hierarchy(
        fine=JaxScenario(nx=g["fine"], ny=g["fine"], t_end=g["t_end"]),
        coarse=JaxScenario(nx=g["coarse"], ny=g["coarse"], t_end=g["t_end"]),
    )
    th = make_hierarchy(
        fine=TohokuScenario(nx=g["fine"], ny=g["fine"], t_end=g["t_end"], device=CPU),
        coarse=TohokuScenario(nx=g["coarse"], ny=g["coarse"], t_end=g["t_end"], device=CPU),
    )
    th["problem"].y_obs = np.asarray(jh["problem"].y_obs)
    x = np.random.default_rng(0).uniform(-200, 200, (16, 2)).astype(np.float32)
    ys = np.stack([np.asarray(jh["forward_coarse"](jnp.asarray(t))) for t in x])
    gj = jax_fit_gp(x, ys, steps=20)
    fields = {
        "x_train": gj.x_train, "y_train": gj.y_train, "y_mean": gj.y_mean,
        "y_scale": gj.y_scale, "log_lengthscales": gj.params.log_lengthscales,
        "log_outputscale": gj.params.log_outputscale, "log_noise": gj.params.log_noise,
        "chol": gj.chol, "alpha": gj.alpha,
    }
    th["gp"] = gp_from_arrays({k: np.asarray(v) for k, v in fields.items()}, device=CPU)
    jh["gp"] = gj
    return jh, th


THETAS = np.asarray([[0.0, 0.0], [-120.0, 80.0], [150.0, -60.0], [60.0, 190.0],
                     [250.0, 0.0], [-10.0, -201.0]], np.float32)


def test_tohoku_prior_and_likelihood_match_jax(tohoku):
    jh, th = tohoku
    jp, tp = jh["problem"], th["problem"]
    got = tp.log_prior_torch(torch.from_numpy(THETAS)).numpy()
    want = np.asarray(jax.vmap(jp.log_prior_jax)(jnp.asarray(THETAS)))
    assert got.dtype == np.float32
    assert np.array_equal(np.isinf(got), np.isinf(want)) and np.isinf(got[-2:]).all()
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-6)
    obs = (jp.y_obs + np.random.default_rng(1).normal(size=(6, 4)) * 0.05).astype(np.float32)
    got = tp.log_likelihood_torch(torch.from_numpy(obs)).numpy()
    want = np.asarray(jax.vmap(jp.log_likelihood_jax)(jnp.asarray(obs)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _ll_bound(problem, obs, atol):
    """How far a Gaussian log likelihood may move when every observable
    moves by at most ``atol``: sum_i |r_i| atol / sigma_i + (atol / sigma_i)^2 / 2,
    with r the normalised residuals."""
    sigma = problem.noise_sigma()
    r = (np.asarray(obs, np.float64) - problem.y_obs) / sigma
    return np.sum(np.abs(r) * atol / sigma + 0.5 * (atol / sigma) ** 2, axis=-1)


def test_tohoku_device_densities_match_jax_composition(tohoku):
    """lp_gp and lp_coarse against the reference's composition (prior +
    likelihood of the JAX GP and the jitted coarse forward): within the
    bound that the observables' atol implies through noise_sigma."""
    jh, th = tohoku
    jp = jh["problem"]
    inside = THETAS[:4]
    lp_gp, lp_coarse = device_densities(th["problem"], th["gp"], th["forward_coarse_batch"])
    for lp, forward, atol in ((lp_gp, jh["gp"], GP_ATOL), (lp_coarse, jh["forward_coarse"],
                                                           OBS_ATOL)):
        obs_j = np.stack([np.asarray(forward(jnp.asarray(t))) for t in inside])
        want = np.array([float(jp.log_prior_jax(jnp.asarray(t)) + jp.log_likelihood_jax(o))
                         for t, o in zip(inside, obs_j)])
        got = lp(torch.from_numpy(inside)).numpy()
        bound = _ll_bound(jp, obs_j, atol)
        assert np.all(np.abs(got - want) <= bound), (got, want, bound)
        assert np.isneginf(lp(torch.from_numpy(THETAS[4:])).numpy()).all()


def test_tohoku_density_rows_do_not_depend_on_b(tohoku):
    _, th = tohoku
    x = torch.from_numpy(THETAS)
    for lp in device_densities(th["problem"], th["gp"], th["forward_coarse_batch"]):
        rows = torch.cat([lp(x[i:i + 1]) for i in range(len(x))])
        assert torch.equal(lp(x), rows)


def test_tohoku_fused_bit_identity(tohoku):
    _, th = tohoku
    densities = device_densities(th["problem"], th["gp"], th["forward_coarse_batch"])
    theta0 = THETAS[:3] * 0.5
    dev, dev_counts = fused_chains(densities, [3], 15.0, theta0, 6, seed=2)
    ref, ref_counts = host_chains(densities, [3], 15.0, theta0, 6, seed=2)
    assert np.array_equal(bits(dev), bits(ref)) and dev_counts == ref_counts


def test_tohoku_coupled_bit_identity(tohoku):
    """GP and coarse on the device, the fine level through the balancer's
    pool: bit-identical to step machines evaluating the fine level as the
    pool does."""
    _, th = tohoku
    prob, fine_batch = th["problem"], th["forward_fine_batch"]
    densities = device_densities(prob, th["gp"], th["forward_coarse_batch"])
    theta0 = THETAS[:3] * 0.5

    def serve(thetas):
        return fine_batch(torch.as_tensor(np.asarray(thetas, np.float32))).numpy()

    runner, bal = balanced_mlda(
        [Server(lambda t: serve([t])[0], name="fine-0", capacity_tags=("level2",))],
        prob.log_likelihood, prob.log_prior, GaussianRandomWalk(15.0), [3, 2],
        device_resident=True, device_densities=densities, ensemble_seed=0, device=CPU,
    )
    try:
        res = runner.run(theta0, 4)
    finally:
        bal.shutdown()

    def fine(t):
        lp = float(prob.log_prior(np.asarray(t)))
        return lp if not np.isfinite(lp) else lp + float(prob.log_likelihood(serve([t])[0]))

    keys = chain_keys(0, 3)
    for c in range(3):
        samp = MLDASampler([host(densities[0]), host(densities[1]), fine],
                           DeviceMatchedRandomWalk(15.0), [3, 2])
        chain = samp.sample(theta0[c], 4, CounterStream(keys[c]))
        assert np.array_equal(bits(chain), bits(res.chains[c]))
        assert counts_of(samp) == counts_of(res.samplers[c])
    assert res.level_totals()[2]["n_evals"] > 3  # the fine pool solved proposals


# -- on the card --------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fused_bit_identity_on_card(card):
    """The same contract through the captured graphs: the fused ensemble on
    the card against step machines drawing from CounterStream on the card."""
    ens = make_device_ensemble([lp0, lp2, lp1], [3, 2], 0.8, device=card)
    state, thetas, _ = ens.advance(ens.init(THETA0, seed=7), 25)
    keys = chain_keys(7, 3, card)
    for c in range(3):
        samp = MLDASampler(
            [lambda t, lp=lp: float(lp(torch.as_tensor(np.asarray(t, np.float32),
                                                       device=card)[None])[0])
             for lp in (lp0, lp2, lp1)],
            DeviceMatchedRandomWalk(0.8), [3, 2],
        )
        chain = samp.sample(THETA0[c], 25, CounterStream(keys[c]))
        assert np.array_equal(bits(chain), bits(thetas[c].cpu().numpy()))
        counts = state.counts[c].cpu().numpy()
        assert counts_of(samp) == [tuple(int(v) for v in row) for row in counts]
    assert ens.executables  # one captured graph per (program, padded C)
