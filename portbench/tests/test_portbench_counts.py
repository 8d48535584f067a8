"""The yardstick's counts: the fused SWE step's bytes and the served
model's FLOPs (its architecture module's)."""
from __future__ import annotations

import json

import pytest

from portbench.tests import tiny
from portbench.counts import swe
from portbench.harness.cells import load_arch


def test_fused_step_bound_at_288_by_8():
    # 288 x 288 cells, 8 members: 6 planes of each member read and written,
    # the bathymetry once, 2 probe values a member; 0.004853 ms at 3.35 TB/s.
    assert swe.fused_step_bytes(8, 288, 288) == (6 * 8 + 1) * 288 * 288 * 4 + 8 * 2 * 4
    assert swe.fused_step_bound_s(8, 288, 288) * 1e3 == pytest.approx(0.004853, abs=5e-7)


@pytest.mark.parametrize("b, ny, nx", [(1, 96, 96), (2, 288, 288), (8, 96, 96), (4, 33, 17)])
def test_fused_step_scales_with_batch_and_grid(b, ny, nx):
    plane = ny * nx * 4
    assert swe.fused_step_bytes(b, ny, nx) == 6 * b * plane + plane + 8 * b
    assert swe.fused_step_bytes(2 * b, ny, nx) - swe.fused_step_bytes(b, ny, nx) == \
        b * (6 * plane + 8)


def _granite():
    return json.loads((tiny.ROOT / "portbench/configs/granite-moe-3b-a800m.json").read_text())


def test_granite_active_parameters():
    c = _granite()
    gm = load_arch(c["model_type"])
    d, f, v = 1536, 512, 49155
    attn = d * 24 * 64 + 2 * d * 8 * 64 + 24 * 64 * d
    per_layer = attn + d * 40 + 8 * 3 * d * f
    assert gm.layer_params_per_token(c) == per_layer
    assert gm.head_params(c) == d * v  # the head, tied to the embedding: still d x v a token
    assert gm.active_params(c) == 32 * per_layer + d * v
    assert gm.active_params(c) == pytest.approx(0.88e9, rel=0.01)


def test_granite_token_flops():
    c = _granite()
    gm = load_arch(c["model_type"])
    assert gm.decode_token_flops(c, 0) == 2 * gm.active_params(c) + 4 * 32 * 24 * 64
    assert gm.attention_flops(c, 99) == 100 * gm.attention_flops(c, 0)
    p = 37
    by_token = sum(2 * (gm.active_params(c) - gm.head_params(c)) + gm.attention_flops(c, i)
                   for i in range(p)) + 2 * gm.head_params(c)
    assert gm.prompt_flops(c, p) == by_token
