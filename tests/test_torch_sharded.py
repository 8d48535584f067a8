"""The port's sharded batch pools, as ``tests/test_sharded_server.py`` holds
the reference's.

``ShardedBatchServer`` must be a drop-in replacement for a plain batch
server: bitwise-equal rows (both sides run through the same
``GraphBatchCache`` path), the same per-member ``check_finite`` scatter,
and an unsharded call at the mesh's first position when the pow2-padded
batch does not divide the mesh.  Torch has no multi-device CPU backend, so
the meshes here are 1, 2 and 4 entries of ``torch.device("cpu")``: the
split, the per-position graph caches and the gather are the same code the
card runs.  Then the port against the reference: the same ``(B, 3) -> (B,
2)`` function through both packages' sharded pools, ``ShardingPolicy``'s
arithmetic on a duck-typed mesh, and the tiny Tōhoku scenario's sharded
observables against the JAX batched forward.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.balancer import ShardedBatchServer as JaxShardedBatchServer
from repro.runtime.sharding import ShardingPolicy as JaxShardingPolicy
from repro.runtime.sharding import data_policy as jax_data_policy
from repro.swe import TohokuScenario as JaxScenario
from repro_torch.balancer import BatchServer, ShardedBatchServer
from repro_torch.configs.tohoku_mlda import CPU
from repro_torch.core import GaussianRandomWalk, balanced_mlda
from repro_torch.core.gp import fit_gp
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import DataMesh, ShardingPolicy, data_mesh, data_policy
from repro_torch.swe import (
    TohokuScenario,
    local_level_servers,
    make_hierarchy,
    make_level_servers,
    stacked_factory,
    train_level0_gp,
)
from repro_torch.swe.solver import GraphBatchCache


def stacked_fn(stacked):
    """(B, 3) -> (B, 2): includes a transcendental so recomputation or
    reordering differences would show up in the bits."""
    q = torch.sum(stacked * stacked, dim=-1)
    return torch.stack([q, torch.exp(-0.5 * q)], dim=-1)


def jax_stacked_fn(stacked):
    q = jnp.sum(stacked * stacked, axis=-1)
    return jnp.stack([q, jnp.exp(-0.5 * q)], axis=-1)


def cpu_policy(n: int) -> ShardingPolicy:
    return data_policy(data_mesh(n, device="cpu"))


def graph_matched_plain(fn, name):
    """A BatchServer whose handler runs through the same GraphBatchCache
    path as the sharded pool: the fair bitwise baseline."""
    cache = GraphBatchCache(fn, key=("test-plain", name), pad="repeat", name=name)

    def run(stacked):
        out, n = cache(torch.from_numpy(np.asarray(stacked)))
        return out[:n].numpy()

    return BatchServer(run, name=f"plain-{name}")


def _thetas(batch: int):
    rng = np.random.default_rng(batch)
    return [rng.normal(size=3).astype(np.float32) for _ in range(batch)]


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 3, 8, 11, 16, 64])
def test_sharded_matches_plain_bitwise(n_dev, batch):
    sharded = ShardedBatchServer(
        lambda _device: stacked_fn, cpu_policy(n_dev), name="pool",
        cache_key=("test", batch),
    )
    thetas = _thetas(batch)
    got = sharded.batch_call(thetas)
    want = graph_matched_plain(stacked_fn, f"b{batch}").batch_call(thetas)
    assert len(got) == len(want) == batch
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).view(np.uint32), np.asarray(w).view(np.uint32))
    # Every shard of the padded batch ran at its own mesh position.
    n_pad = 1 << (batch - 1).bit_length()
    n_shards = n_dev if n_pad % n_dev == 0 else 1
    assert sorted(sharded.executables) == [(i, n_pad // n_shards) for i in range(n_shards)]


def test_indivisible_batch_falls_back_unsharded():
    """B = 2 pads to 2; on a 4-entry mesh 2 < |mesh|, so batch_axes is None
    and the pool takes one unsharded call at position 0."""
    policy = cpu_policy(4)
    assert policy.batch_axes(2) is None
    assert policy.batch_axes(4) == ("data",)
    assert policy.batch_axes(64) == ("data",)
    sharded = ShardedBatchServer(lambda _d: stacked_fn, policy, name="pad-pool")
    assert sharded.shards(2) == [(0, 0, 2)]
    assert sharded.shards(8) == [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]
    thetas = [np.full(3, 0.25 * (i + 1), np.float32) for i in range(2)]
    got = sharded.batch_call(thetas)
    want = graph_matched_plain(stacked_fn, "pad").batch_call(thetas)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert sorted(sharded.executables) == [(0, 2)]


def test_duplicate_devices_get_a_shard_each_and_one_forward():
    """A mesh listing one device twice: two positions, two graph caches,
    and the device's forward built once."""
    built = []

    def factory(device):
        built.append(device)
        return stacked_fn

    mesh = DataMesh(["cpu", "cpu"])
    assert mesh.shape == {"data": 2} and mesh.axis_names == ("data",)
    sharded = ShardedBatchServer(factory, data_policy(mesh), name="dup")
    for batch in (8, 8, 3):
        sharded.batch_call(_thetas(batch))
    assert built == [torch.device("cpu")]
    assert sorted(sharded.executables) == [(0, 2), (0, 4), (1, 2), (1, 4)]


def test_check_finite_scatters_per_member():
    """One poisoned member fails alone; batch mates still get results."""
    sharded = ShardedBatchServer(
        lambda _d: stacked_fn, cpu_policy(2), name="nan-pool", check_finite=True,
    )
    thetas = [np.ones(3, np.float32) * 0.1 for _ in range(8)]
    thetas[5] = np.array([np.nan, 0.0, 0.0], np.float32)
    results = sharded.batch_call(thetas)
    assert isinstance(results[5], FloatingPointError)
    for i, r in enumerate(results):
        if i != 5:
            assert np.all(np.isfinite(np.asarray(r)))


def test_data_mesh_devices_and_refusals():
    assert data_mesh(4, device="cpu").devices == (torch.device("cpu"),) * 4
    assert data_mesh(device="cpu").shape == {"data": 1}
    policy = data_policy(data_mesh(2, device="cpu"))
    assert (policy.dp_axes, policy.model_axis, policy.fsdp) == (("data",), None, False)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested"):
            data_mesh(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            data_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            data_policy()
    # The tensor-parallel layout is ported (item 10): each refuses a bad
    # argument as the reference's does, and the context takes a policy.
    from repro.runtime import sharding as jax_sharding

    for package in (sharding, jax_sharding):
        with pytest.raises(KeyError):
            package.choose_policy(None, None, FakeMesh((("data", 8),)))
        with pytest.raises(AttributeError):
            package.param_spec(None, [], None)
        with package.activation_sharding(None):
            pass


class FakeMesh:
    """Duck-typed mesh: ShardingPolicy only reads .shape and .axis_names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def _policies(pure_dp: bool):
    mesh = FakeMesh((("data", 16), ("model", 16)))
    if pure_dp:
        kw = dict(mesh=mesh, dp_axes=("data", "model"), model_axis=None)
    else:
        kw = dict(mesh=mesh, dp_axes=("data",))
    return JaxShardingPolicy(**kw), ShardingPolicy(**kw)


@pytest.mark.parametrize("dim,axis,want", [(32, "model", "model"), (14, "model", None),
                                           (0, "model", "model"), (32, None, None),
                                           (256, ("data", "model"), ("data", "model")),
                                           (128, ("data", "model"), None)])
def test_shard_if_matches_reference(dim, axis, want):
    ref, port = _policies(pure_dp=False)
    assert ref.shard_if(dim, axis) == port.shard_if(dim, axis) == want


@pytest.mark.parametrize("batch,want", [(256, ("data", "model")), (128, ("data",)),
                                        (16, ("data",)), (7, None)])
def test_batch_axes_fallback_chain_matches_reference(batch, want):
    ref, port = _policies(pure_dp=True)
    assert ref.batch_axes(batch) == port.batch_axes(batch) == want
    assert (ref.dp_size, ref.tp_size) == (port.dp_size, port.tp_size) == (256, 1)


@pytest.mark.parametrize("batch", [3, 8])
def test_rows_match_reference_sharded_pool(batch):
    """The same function through both packages' sharded pools: exp differs
    across frameworks, so rtol 1e-6."""
    thetas = _thetas(batch)
    ref = JaxShardedBatchServer(jax_stacked_fn, jax_data_policy(), name="ref",
                                cache_key=("torch-port", batch))
    port = ShardedBatchServer(lambda _d: stacked_fn, cpu_policy(2), name="port")
    for g, w in zip(port.batch_call(thetas), ref.batch_call(thetas)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=0)


def _tiny_gp():
    rng = np.random.default_rng(0)
    x = rng.uniform(-200, 200, (16, 2)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0] / 90), np.cos(x[:, 1] / 70), x[:, 0] / 400,
                  x[:, 1] / 300], axis=1).astype(np.float32)
    return fit_gp(x, y, steps=5, device="cpu")


def test_make_level_servers_wires_one_sharded_pool():
    """With a policy + stacked forwards, each level gets ONE sharded pool
    instead of ``servers_per_level`` BatchServer replicas."""
    w = dataclasses.replace(CPU, batch_solves=True)
    gp = _tiny_gp()
    f = lambda _t: None  # noqa: E731 - single forwards: unused when sharded
    f.device = torch.device("cpu")
    servers = make_level_servers(
        w, gp, f, f, stacked_forwards=(None, lambda _d: stacked_fn, lambda _d: stacked_fn),
        policy=cpu_policy(2),
    )
    assert all(isinstance(s, ShardedBatchServer) for s in servers)
    assert [s.name for s in servers] == ["gp-0", "coarse-pool", "fine-pool"]
    assert [next(iter(s.capacity_tags)) for s in servers] == ["level0", "level1", "level2"]
    # Level 0 is the GP's batch_call, sharded: rows equal the GP's own.
    th = [np.array([10.0 * i, -5.0 * i], np.float32) for i in range(5)]
    want = gp.batch_call(torch.from_numpy(np.stack(th))).numpy()
    assert np.array_equal(np.stack(servers[0].batch_call(th)), want)
    assert sorted(servers[0].executables) == [(0, 4), (1, 4)]


def test_mesh_devices_alone_shards_the_pools():
    """``MLDAWorkloadConfig.mesh_devices`` alone (no explicit policy) derives
    the mesh on the GP's device type: every level becomes one pool."""
    w = dataclasses.replace(CPU, batch_solves=True, mesh_devices=2)
    gp = _tiny_gp()
    f = lambda _t: None  # noqa: E731
    f.device = torch.device("cpu")
    servers = make_level_servers(
        w, gp, f, f, stacked_forwards=(None, lambda _d: stacked_fn, lambda _d: stacked_fn),
    )
    assert [type(s) for s in servers] == [ShardedBatchServer] * 3
    assert servers[0].policy.mesh.devices == (torch.device("cpu"),) * 2
    # Without stacked forwards only the GP's level shards.
    servers = make_level_servers(
        w, gp, f, f, batch_forwards=(None, lambda t: t, lambda t: t),
    )
    assert isinstance(servers[0], ShardedBatchServer)
    assert [type(s) for s in servers[1:]] == [BatchServer] * (
        CPU.servers_per_level.get(1, 1) + CPU.servers_per_level.get(2, 1))


TINY = dataclasses.replace(
    CPU, coarse_grid=(16, 16), fine_grid=(24, 24), t_end_s=1200.0,
    gp_train_points=16, gp_opt_steps=8, n_chains=2, n_fine_samples=3,
    subchain_lengths=(3, 2), max_batch=4,
)


@pytest.fixture(scope="module")
def tiny_hierarchy():
    h = make_hierarchy(
        fine=TohokuScenario(nx=24, ny=24, t_end=TINY.t_end_s, device="cpu"),
        coarse=TohokuScenario(nx=16, ny=16, t_end=TINY.t_end_s, device="cpu"),
    )
    h["gp"] = train_level0_gp(h["forward_coarse_batch"], h["problem"],
                              n_train=TINY.gp_train_points, steps=TINY.gp_opt_steps)
    return h


def test_tohoku_sharded_observables_match_reference():
    """The tiny scenario's sharded pool on a 2-entry mesh: rows equal the
    port's batched forward bit for bit, and the JAX batched forward within
    the scenario tolerance (fp32 linspace differs in the last ulp)."""
    ts = TohokuScenario(nx=16, ny=16, t_end=1200.0, device="cpu")
    js = JaxScenario(nx=16, ny=16, t_end=1200.0)
    thetas = [np.array(t, np.float32) for t in ([0.0, 0.0], [-120.0, 80.0], [150.0, -60.0])]
    pool = ShardedBatchServer(stacked_factory(ts), cpu_policy(2), name="fine-pool")
    got = np.stack(pool.batch_call(thetas))
    assert sorted(pool.executables) == [(0, 2), (1, 2)]
    assert np.array_equal(got, ts.build_batch_forward()(torch.from_numpy(np.stack(thetas))).numpy())
    want = np.asarray(js.build_batch_forward()(jnp.asarray(np.stack(thetas))))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def _chains(h, **servers_kw):
    prob = h["problem"]
    servers = local_level_servers(TINY, h["gp"], h, **servers_kw)
    runner, lb = balanced_mlda(
        servers, prob.log_likelihood, prob.log_prior, GaussianRandomWalk(TINY.rw_step_km),
        list(TINY.subchain_lengths), batchable_levels=TINY.batchable_levels,
        n_chains=TINY.n_chains, ensemble_seed=0, speculative=True, as_runner=True,
        **TINY.batch_kwargs(),
    )
    try:
        res = runner.run(lambda c, rng: prob.sample_prior(rng)[0] * 0.5, TINY.n_fine_samples)
    finally:
        lb.shutdown()
    return servers, res


def test_sharded_pools_sample_the_same_chains(tiny_hierarchy):
    """The MLDA main path through one sharded pool a level (2-entry CPU
    mesh) gives the BatchServer pools' chains bit for bit."""
    servers, sharded = _chains(tiny_hierarchy, policy=cpu_policy(2))
    assert [s.name for s in servers] == ["gp-0", "coarse-pool", "fine-pool"]
    assert all(isinstance(s, ShardedBatchServer) for s in servers)
    _, plain = _chains(tiny_hierarchy)
    assert not sharded.failures
    assert np.array_equal(sharded.chains, plain.chains)


def test_tsunami_run_with_mesh_devices_and_checkpoint_dir(tmp_path, capsys):
    """The entry point at TINY size: ``mesh_devices`` makes each level one
    sharded pool, and ``checkpoint_dir`` lands a snapshot per chain."""
    from repro_torch.launch.tsunami import run

    w = dataclasses.replace(TINY, mesh_devices=2, max_restarts=1, checkpoint_every=1)
    res = run(w, device="cpu", checkpoint_dir=str(tmp_path), log=print)
    assert res["chains"].shape == (2, TINY.n_fine_samples, 2)
    assert np.isfinite(res["chains"]).all() and not res["failures"]
    uptime = res["balancer"]["per_server_uptime"]
    assert sorted(uptime) == ["coarse-pool", "fine-pool", "gp-0"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "chain_0.npz", "chain_0.npz.meta.json", "chain_1.npz", "chain_1.npz.meta.json"]
    assert "[4/4]" in capsys.readouterr().out


def test_tsunami_run_refuses_checkpoint_dir_without_restarts(tmp_path):
    """A snapshot is read only on a restart: ``checkpoint_dir`` with
    ``max_restarts`` 0 is refused before anything is built or written."""
    from repro_torch.launch.tsunami import run

    with pytest.raises(ValueError, match="max_restarts"):
        run(TINY, device="cpu", checkpoint_dir=str(tmp_path), log=print)
    assert not list(tmp_path.iterdir())
