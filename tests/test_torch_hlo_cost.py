"""The port's per-device cost counter (``launch/hlo_cost.py``), the
reference's ``tests/test_hlo_cost.py`` recast for eager code.

The reference checks that its HLO parser multiplies scan bodies by their
trip counts.  Eager code dispatches every iteration, so the same cases
hold here as Python loops: n matmuls count n times, nested loops their
product, and on one device the flops equal ``FlopCounterMode``'s.  Then
what only a sharded count has: on a (2, 4) fake mesh (a subprocess; the
process group is global to a process) a product sharded on both dims
counts one eighth of the global flops, a replicated one the whole, and
the collective bytes equal a hand count.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.hlo_cost import COLLECTIVE_KINDS, analyze

REPO = os.path.join(os.path.dirname(__file__), "..")
N = 256


def _loop(n):
    def f(x, w):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x

    return f


def _inputs():
    g = torch.Generator().manual_seed(0)
    return torch.randn(N, N, generator=g), torch.randn(N, N, generator=g)


@pytest.mark.parametrize("n", [1, 4, 16])
def test_loop_flops_scale_with_iterations(n):
    s = analyze(_loop(n), *_inputs())
    assert s.flops == 2 * N**3 * n


def test_matches_flop_counter_mode():
    x, w = _inputs()
    with FlopCounterMode(display=False) as fc:
        _loop(8)(x, w)
    assert analyze(_loop(8), x, w).flops == fc.get_total_flops()


def test_nested_loops():
    def g(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    assert analyze(g, *_inputs()).flops == 2 * N**3 * 15


def test_bytes_peak_and_collectives_on_one_device():
    x, w = _inputs()
    s = analyze(_loop(4), x, w)
    assert s.bytes > 0
    # Per iteration: the product reads 2 and writes 1 matrix, tanh reads and
    # writes one (fp32, no views).
    assert s.bytes == 4 * (3 + 2) * N * N * 4
    assert s.collective_bytes == 0 and s.collective_count == 0
    assert set(s.collectives) == set(COLLECTIVE_KINDS)
    assert s.peak_bytes >= 3 * N * N * 4  # the two arguments and a result


def test_products_of_every_overload_and_the_attention_scope():
    from repro_torch.models import chunked_attention

    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(3, 8, 16, generator=g), torch.randn(3, 16, 4, generator=g)
    bias = torch.randn(8, 4, generator=g)
    s = analyze(lambda: (torch.bmm(a, b), torch.addmm(bias, a[0], b[0]),
                         torch.baddbmm(a @ b, a, b)))
    assert s.flops == 2 * 8 * 4 * 16 * (3 + 1 + 3 + 3)
    q = torch.randn(1, 2, 32, 16, generator=g)
    # Looked up at call time, as the attention dispatch does.
    s = analyze(lambda: chunked_attention.attention_chunked(q, q, q, block_k=8))
    # Two products (scores, values) a key block of 8, four blocks.
    assert s.attention_flops == s.flops == 2 * (2 * 32 * 8 * 16) * 2 * 4
    assert 0 < s.attention_bytes <= s.bytes
    s = analyze(lambda: a @ b)
    assert s.attention_flops == 0 and s.attention_bytes == 0


SHARDED_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.hlo_cost import analyze
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
M, K, N = 64, 32, 128
out = {}
with FakeTensorMode(allow_non_fake_inputs=True):
    x = torch.empty(M, K)
    w = torch.empty(K, N)
    # Output sharded on both dims: rows over data, columns over model.
    xs = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    ws = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
    s = analyze(lambda a, b: a @ b, xs, ws)
    out["both"] = [s.flops, s.collective_bytes]
    xr = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    wr = distribute_tensor(w, mesh, [Replicate(), Replicate()])
    s = analyze(lambda a, b: a @ b, xr, wr)
    out["replicated"] = [s.flops, s.collective_bytes]
    # Contracted dim split over model: Partial over 4, then all-reduced.
    xk = distribute_tensor(x, mesh, [Shard(0), Shard(1)])
    wk = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
    def contract(a, b):
        return (a @ b).redistribute(mesh, [Shard(0), Replicate()])
    s = analyze(contract, xk, wk)
    out["contracted"] = [s.flops, s.collective_bytes, s.collectives["all-reduce"],
                         s.collective_count]
    s = analyze(lambda a: a.redistribute(mesh, [Replicate(), Replicate()]), xs)
    out["gather"] = [s.collectives["all-gather"], s.collective_count]
print("RESULT:" + json.dumps(out))
"""


def test_sharded_counts_are_one_devices_share():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SHARDED_SCRIPT], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")]
    out = json.loads(line[0][len("RESULT:"):])
    m, k, n = 64, 32, 128
    full = 2 * m * k * n
    assert out["both"] == [full / 8, 0]
    assert out["replicated"] == [full, 0]
    # Each rank: its 32 rows times a quarter of K, all 128 columns; the
    # all-reduce returns the (32, 128) fp32 partial sums.
    flops, coll, ar, count = out["contracted"]
    assert flops == full / 8 and coll == ar == 32 * 128 * 4 and count == 1
    # x's rows gathered over data: one all-gather returning the (64, 32).
    assert out["gather"] == [m * k * 4, 1]
