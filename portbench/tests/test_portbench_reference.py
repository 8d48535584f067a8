"""The plain references against the program's plain path at small sizes on
the CPU, and their controls (the next lower precision) failing where the
program passes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench.harness.weights import make_weights, program_tree
from portbench.reference import lm as ref_lm
from portbench.reference import tohoku as ref_tohoku

THETAS = np.array([[0.0, 0.0], [-150.0, 120.0], [80.5, -33.25], [199.0, -199.0]])


def _scenario(n):
    from repro_torch.swe import TohokuScenario

    return TohokuScenario(nx=n, ny=n, t_end=900.0, device="cpu")


@pytest.mark.parametrize("n", [16, 24])
def test_tohoku_reference_matches_the_program(n):
    sc = _scenario(n)
    fwd = sc.build_batch_forward()
    prog = fwd(torch.as_tensor(THETAS, dtype=torch.float32)).numpy()
    grid = ref_tohoku.Grid(n, n, 900.0, torch.float64, torch.device("cpu"))
    assert grid.n_steps == fwd.n_steps
    assert grid.probes == list(sc.probe_indices())
    ref = grid.observables(torch.as_tensor(THETAS.astype(np.float32), dtype=torch.float64))
    # float32 resolves a sea surface at 7 km depth to 0.5 mm (one ulp of h),
    # and the soft arrival time turns a step of 0.5 mm at the 50 mm
    # threshold into a tenth of its sigmoid: at these grids the program reads
    # up to 0.36 sigma from the float64 reference (0.007 in heights).
    assert ref_tohoku.obs_error_sigma(prog, ref.numpy()) < 0.5


def test_tohoku_control_fails():
    grid = ref_tohoku.Grid(16, 16, 900.0, torch.float64, torch.device("cpu"))
    low = ref_tohoku.Grid(16, 16, 900.0, torch.bfloat16, torch.device("cpu"))
    x = torch.as_tensor(THETAS)
    err = ref_tohoku.obs_error_sigma(low.observables(x.to(torch.bfloat16)).double().numpy(),
                                     grid.observables(x).numpy())
    assert err > 1.0


def test_gp_reference_matches_the_program():
    from repro_torch.core.gp import fit_gp

    rng = np.random.default_rng(3)
    x = rng.uniform(-200, 200, size=(24, 2)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0] / 90) + 0.1 * x[:, 1] / 200, np.cos(x[:, 1] / 70)], 1)
    prog = fit_gp(x, y.astype(np.float32), steps=30, device="cpu")
    ref = ref_tohoku.fit_gp(torch.as_tensor(x, dtype=torch.float64),
                            torch.as_tensor(y, dtype=torch.float64), steps=30)
    q = torch.as_tensor(rng.uniform(-200, 200, size=(16, 2)))
    a = prog.predict(q.float()).double().numpy()
    b = ref.mean(q).numpy()
    assert np.abs(a - b).max() < 1e-3 * np.abs(b).max()
    assert np.abs(ref.mean(q, torch.bfloat16).double().numpy() - b).max() > 10 * np.abs(a - b).max()


def test_lhs_design_is_the_programs():
    from repro_torch.core.lhs import latin_hypercube, scale_to_bounds

    u = latin_hypercube(torch.Generator().manual_seed(0), 64, 2)
    prog = scale_to_bounds(u, ref_tohoku.PRIOR_LO, ref_tohoku.PRIOR_HI)
    assert torch.equal(ref_tohoku.lhs_design(64), prog)


@pytest.mark.parametrize("tied", [True, False])
def test_lm_reference_matches_the_program(tied):
    from repro_torch.models import lm
    from portbench.harness.serving import arch_config

    cfg = {**tiny.LM["config"], **{k: v for k, v in _granite().items()
                                   if k not in tiny.LM["config"]}}
    cfg["tie_word_embeddings"] = tied
    cfg["capacity_factor"] = 8.0  # no drops in the program's own forward
    w = make_weights(cfg, 11, "cpu")
    assert ("unembed" in w) is not tied
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, 256, size=40))
    prog = lm.forward(program_tree(w, cfg), arch_config(cfg), {"tokens": tokens[None]})[0]
    ref = ref_lm.Reference(w, cfg).logits(tokens)
    assert torch.allclose(prog, ref, atol=1e-4, rtol=0)
    served = prog[:-1].argmax(-1)[20:]
    assert float(ref_lm.served_gaps(ref, 21, served).max()) < 1e-4
    ctl = ref_lm.Reference(w, cfg, quant="fp8").logits(tokens)
    assert float(ref_lm.control_gaps(ref, ctl, 21, len(served)).max()) > 1e-2


def _granite():
    import json

    return json.loads((tiny.ROOT / "portbench/configs/granite-moe-3b-a800m.json").read_text())


def _batches(sizes):
    rows = np.arange(sum(sizes), dtype=np.float64)
    out, i = [], 0
    for n in sizes:
        out.append((np.stack([rows[i:i + n]] * 2, 1), np.stack([rows[i:i + n]] * 4, 1)))
        i += n
    return out


@pytest.mark.parametrize("sizes, k", [([1, 3, 1, 1, 2, 1, 8, 1], 8), ([1] * 20, 8),
                                      ([4, 4, 2, 4], 8), ([2, 1], 16)])
def test_sample_batches_takes_whole_batches(sizes, k):
    batches = _batches(sizes)
    th, ob = ref_tohoku.sample_batches(batches, k, np.random.default_rng(3))
    picked = {int(r) for r in th[:, 0]}
    whole = [{int(r) for r in t[:, 0]} for t, _ in batches]
    assert all(b <= picked or not (b & picked) for b in whole)  # no batch split
    assert np.array_equal(th[:, 0], ob[:, 0])
    n_multi = sum(n > 1 for n in sizes)
    taken_multi = sum(len(b) > 1 and b <= picked for b in whole)
    assert taken_multi >= min(n_multi, 1)
    n_single = sum(n == 1 for n in sizes)
    assert sum(len(b) == 1 and b <= picked for b in whole) >= min(n_single, k // 2)
    assert len(picked) <= k + max(sizes) - 1

