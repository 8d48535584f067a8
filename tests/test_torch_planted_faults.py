"""The port's planted faults and the flash-attention route, without a card.

``chip_smoke.py`` builds or loads each of its ``PLANTED_FAULTS`` (one
textual edit of a CUDA source or of the graph module ``graphs.py``) and
fails unless its checks reject every one; an edit that no longer matches
its source would leave a check untested, so each edit is held here against
the source it names, as text.  The flash wrapper's choice
of kernel is a pure function of dtype and head dim (``ops.route``), tested
here for every combination it takes and every one it refuses.
"""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
FAULTS = chip_smoke.PLANTED_FAULTS


def _source(name: str) -> str:
    return chip_smoke.fault_source(name).read_text()


def _span(text: str, start: str, end: str) -> str:
    """The part of ``text`` from ``start`` to the next ``end``."""
    i = text.index(start)
    return text[i : text.index(end, i)]


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_edit_matches_its_source_exactly_once(name):
    source, old, new = FAULTS[name]
    text = _source(source)
    assert text.count(old) == 1
    assert old != new
    assert text.replace(old, new).count(new) == 1


@pytest.mark.parametrize("name", sorted(n for n, f in FAULTS.items() if f[0] == "flash_attention.cu"))
def test_flash_faults_lie_in_the_tensor_core_kernel(name):
    """The flash faults go into the bf16 route, the kernel the LM prefill runs."""
    _, old, _ = FAULTS[name]
    kernel = _span(_source("flash_attention.cu"), "flash_fwd_wgmma_kernel(", "typedef CUresult")
    assert old in kernel


def test_swe_fault_lies_in_the_fused_step_row_loop():
    """The SWE fault edits the row index of the halo-tile loads, which the
    fused step and the y sweep share."""
    source, old, _ = FAULTS["swe_halo_row_own_row"]
    loads = _span(_source(source), "void load_halo_cell(", "s.cell[r][c] = ")
    assert old in loads


def test_sweep_fault_lies_in_the_x_sweep_halo_load():
    """The sweep fault edits the x sweep's load of the tile's edge columns,
    inside the one-direction tile kernel and not in the fused step."""
    source, old, _ = FAULTS["sweep_x_halo_own_column"]
    text = _source(source)
    sweep = _span(text, "__global__ void __launch_bounds__(kTileW * TY, 2048 / (kTileW * TY)) "
                  "swe_sweep_kernel(", "dim3 tile_grid(")
    assert old in _span(sweep, "if (kX) {", "} else if (r < 2)")
    fused = _span(text, "swe_fused_step_kernel(", "swe_sweep_kernel(")
    assert old not in fused


def test_matern_fault_lies_in_the_mean_kernel_tree():
    """The Matérn fault edits the posterior-mean kernel's halving loop."""
    source, old, new = FAULTS["mean_tree_mirror_order"]
    kernel = _span(_source(source), "matern52_mean_kernel(", "}  // namespace")
    loop = _span(kernel, "// The halving levels", "// The last levels")
    assert source == "matern.cu" and old in loop and old != new


def test_sweep_is_the_tile_kernel_in_one_direction():
    """The per-cell sweep is gone: the sweep kernel is a template on the
    direction and the tile height, over the fused step's shared tile."""
    text = _source("swe_flux.cu")
    assert "template <bool kX, int TY>\n__global__" in text
    sweep = _span(text, "swe_sweep_kernel(\n", "dim3 tile_grid(")
    assert "__shared__ StepTile<TY> s;" in sweep and "load_halo_cell(" in sweep
    assert "int axis, float g" not in sweep


def test_every_kernel_source_has_a_fault():
    assert {f[0] for f in FAULTS.values() if f[0].endswith(".cu")} == {
        "flash_attention.cu", "swe_flux.cu", "matern.cu"}
    assert all(f[0] in ("flash_attention.cu", "swe_flux.cu", "matern.cu", "graphs.py")
               for f in FAULTS.values())


@pytest.mark.parametrize("name", ["graph_input_copy_dropped", "graph_outputs_not_cloned"])
def test_graph_faults_lie_in_the_static_graph_call(name):
    """The graph faults edit ``StaticGraph.__call__``, the one copy-in and
    clone-out that every graph of the port (batched solves, forwards and
    decode steps) goes through."""
    source, old, _ = FAULTS[name]
    call = _span(_source(source), "    def __call__(self, *inputs", "    def _order_after_last_replay")
    assert source == "graphs.py" and old in call


@pytest.mark.parametrize("head_dim", ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "cuda_core")])
def test_route_by_dtype(dtype, want, head_dim):
    assert ops.route(dtype, head_dim) == want


@pytest.mark.parametrize("head_dim", [16, 48, 96, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_refuses_head_dims_without_a_kernel(dtype, head_dim):
    with pytest.raises(ValueError, match="head dim"):
        ops.route(dtype, head_dim)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.route(dtype, 64)


def test_wrapper_raises_before_any_launch():
    """What no kernel takes raises in the wrapper; nothing falls back."""
    q, k, v = (torch.zeros(s, dtype=torch.float16) for s in ((1, 2, 8, 64), (1, 1, 8, 64), (1, 1, 8, 64)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q, k, v)
    q, k, v = (x.to(torch.bfloat16)[..., :48].contiguous() for x in (q, k, v))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)


def test_each_route_has_its_entry_point_and_counter():
    text = _source("flash_attention.cu")
    extern_c = text[text.index('extern "C" {'):]
    for route, fn in ops.ROUTES.values():
        assert re.search(rf"\bint {fn}\(", extern_c)
        assert ops.LAUNCHES[route] is build.counter(ops.LAUNCHES[route].name)
    assert len({c.name for c in ops.LAUNCHES.values()}) == len(ops.ROUTES)


def test_fp32_route_kernel_has_no_bf16_instance():
    """The CUDA-core kernel serves fp32 only; bf16 has the tensor-core kernel."""
    fp32 = _span(_source("flash_attention.cu"), "namespace fp32 {", "}  // namespace fp32")
    assert "bfloat16" not in fp32
