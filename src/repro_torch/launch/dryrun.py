"""Multi-pod dry-run: each (architecture x input shape x mesh) cell's
sharded step traced on one rank's shards, allocating nothing.

The port of the reference's ``launch/dryrun.py``.  The mesh is a
``DeviceMesh`` over the ``"fake"`` process-group backend with 256 or 512
ranks (set up by :func:`fake_world` in the process that runs the cells:
the process group is global to a process, as XLA_FLAGS is to the
reference's).  Each cell builds its step with the reference's policy
(``choose_policy``) and attention (``"chunked"``), places fake parameters,
optimizer state and batch (``FakeTensorMode``) as rank 0 holds them, and
runs the step once under :func:`repro_torch.launch.hlo_cost.analyze`.
The JSON keeps the reference's shape: ``memory`` (the peak of live local
bytes; the inputs are updated in place, the reference's donation),
``cost``, ``collectives`` and ``roofline`` with the H100's constants
(:mod:`repro_torch.launch.mesh`).  ``trace_s`` replaces ``lower_s`` and
``compile_s``, and the ``*_kernel`` keys the reference's ``*_pallas``: the
CUDA flash kernel, like the Pallas one, keeps the attention tiles on chip.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
      --mesh single --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch.mesh import (
    CARD,
    HBM_BW,
    MULTI,
    PEAK_FLOPS_BF16,
    SINGLE,
    axis_bandwidth,
    hbm_per_card,
)
from repro_torch.models import abstract_params

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")
ATTN_IMPL = "chunked"  # the reference's dry-run attention


def fake_world(world_size: int) -> None:
    """Start this process's ``"fake"`` process group of ``world_size``
    ranks, as rank 0 (collectives return at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is running")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def model_flops(arch_id: str, shape_name) -> float:
    """6 * N_active * tokens (training) / 2 * N_active * tokens (inference);
    ``shape_name`` a name of ``SHAPES`` or a ``ShapeConfig``."""
    cfg = ARCHS[arch_id]
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    n_total = _param_count(abstract_params(cfg))
    n_active = n_total
    if cfg.moe is not None:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        expert_params = 3 * cfg.d_model * cfg.moe.d_ff * e * cfg.n_layers
        n_active = n_total - expert_params * (1 - k / e)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def _param_count(params) -> int:
    from repro_torch.optim.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(params))


def _fake_like(tree):
    """``meta`` leaves -> CPU tensors of the same shapes under the active
    ``FakeTensorMode`` (nothing allocated)."""
    from repro_torch.optim.tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [torch.empty(t.shape, dtype=t.dtype, device="cpu")
                                 for t in tree_leaves(tree)])


def build_cell(cfg, shape, policy, rt=None):
    """The step of a cell and its placed fake inputs -> (fn, args)."""
    from repro_torch.runtime.serve_loop import shard_decode_step, shard_prefill_step
    from repro_torch.runtime.train_loop import shard_train_step

    if shape.kind == "train":
        fn, abstract = shard_train_step(cfg, shape, policy, rt)
    elif shape.kind == "prefill":
        fn, abstract = shard_prefill_step(cfg, shape, policy)
    else:
        fn, abstract = shard_decode_step(cfg, shape, policy)
    return fn, fn.place(*(_fake_like(a) for a in abstract))


def trace_cell(cfg, shape, policy, rt=None):
    """Trace one step of a cell on rank 0's shards under ``FakeTensorMode``
    -> (CostSummary, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_cost import analyze

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_cell(cfg, shape, policy, rt)
        summary = analyze(fn, *args)
    return summary, time.time() - t0


ONE = ((1, 1), ("data", "model"))


def _one_mesh():
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", ONE[0], mesh_dim_names=ONE[1])


def run_cell(arch_id: str, shape_name, mesh_kind: str, *, seq_parallel: bool = False,
             fsdp: bool = True, layout: str = "auto", remat: bool = True,
             mesh=None) -> Dict:
    """One cell -> the reference's JSON record.  ``mesh`` overrides the
    production mesh (a smaller fake mesh in the tests)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import choose_policy, make_policy, mesh_shape

    cfg = dataclasses.replace(ARCHS[arch_id], attn_impl=ATTN_IMPL)
    if not remat:
        cfg = dataclasses.replace(cfg, remat=False)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape.name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}

    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
    sizes = mesh_shape(mesh)
    n_chips = 1
    for v in sizes.values():
        n_chips *= v
    if layout == "auto":
        policy = choose_policy(cfg, shape, mesh, seq_parallel=seq_parallel)
    elif layout == "dp":
        policy = make_policy(mesh, fsdp=fsdp, pure_dp=True)
    else:  # "tp"
        policy = make_policy(mesh, fsdp=fsdp, seq_parallel=seq_parallel)

    from repro_torch.runtime import sharding

    sharding.LAYOUT_EVENTS.clear()
    summary, trace_s = trace_cell(cfg, shape, policy)
    layout_events = dict(sharding.LAYOUT_EVENTS)
    flops = float(summary.flops)
    bytes_accessed = float(summary.bytes)
    coll_bytes = float(summary.collective_bytes)
    # The slowest link any axis takes carries the collectives (per axis
    # bandwidths in repro_torch.launch.mesh; the counter does not split
    # bytes by axis).
    link_bw = min(axis_bandwidth(sizes, a) for a in sizes)
    compute_term = flops / PEAK_FLOPS_BF16
    memory_term = bytes_accessed / HBM_BW
    collective_term = coll_bytes / link_bw
    mf = model_flops(arch_id, shape) / n_chips
    terms = {"compute_s": compute_term, "memory_s": memory_term, "collective_s": collective_term}
    dominant = max(terms, key=terms.get)
    memory_kernel = (bytes_accessed - float(summary.attention_bytes)) / HBM_BW
    terms_kernel = {**terms, "memory_s": memory_kernel}
    peak = int(summary.peak_bytes)
    hbm = hbm_per_card()

    def fraction(t):
        return (mf / PEAK_FLOPS_BF16) / max(t.values()) if mf and max(t.values()) > 0 else None

    return {
        "arch": arch_id,
        "shape": shape.name,
        "mesh": mesh_kind,
        "n_chips": int(n_chips),
        "status": "ok",
        "policy": {"dp_axes": list(policy.dp_axes), "model_axis": policy.model_axis,
                   "fsdp": policy.fsdp, "seq_parallel": policy.seq_parallel},
        "layout_events": layout_events,
        "seq_parallel": seq_parallel,
        "fsdp": fsdp,
        "trace_s": round(trace_s, 1),
        "card": CARD,
        "memory": {
            "peak_bytes": peak,
            "hbm_per_chip": hbm,
            "fits": bool(peak < hbm),
        },
        "cost": {
            "flops_per_device": flops,
            "bytes_per_device": bytes_accessed,
            "attention_bytes": float(summary.attention_bytes),
            "attention_flops": float(summary.attention_flops),
            "unknown_flop_ops": int(summary.unknown_flop_ops),
            "dispatched_ops": int(summary.ops),
        },
        "collectives": {**summary.collectives, "count": summary.collective_count,
                        "total_bytes": coll_bytes},
        "roofline": {
            **terms,
            "dominant": dominant,
            "link_bw": link_bw,
            "model_flops_per_device": mf,
            "useful_flop_ratio": (mf / flops) if (flops and mf) else None,
            "roofline_fraction": fraction(terms),
            "memory_s_kernel": memory_kernel,
            "roofline_fraction_kernel": fraction(terms_kernel),
        },
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both", "one"],
                    help="one: a (1, 1) mesh of one fake rank (the card's own layout)")
    ap.add_argument("--seq-len", type=int, default=None, help="override the shape's length")
    ap.add_argument("--batch", type=int, default=None, help="override the global batch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--layout", default="auto", choices=["auto", "dp", "tp"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cpu", choices=["cpu"],
                    help="the fake ranks' device type (the trace runs on the host)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for m in meshes:
        shape_m, _ = {"multi": MULTI, "single": SINGLE, "one": ONE}[m]
        world = 1
        for v in shape_m:
            world *= v
        if len(meshes) > 1 and m == "multi":
            # One process group a process: the multi-pod mesh needs its
            # own run (--mesh multi).
            print("[dryrun] --mesh both: run --mesh multi in its own process", flush=True)
            continue
        fake_world(world)
        for a in archs:
            for s in shapes:
                s_name = s if not (args.seq_len or args.batch) else (
                    f"{s}_{args.seq_len}x{args.batch}")
                name = f"{a}__{s_name}__{m}{args.tag}.json"
                path = os.path.join(args.out, name)
                if os.path.exists(path) and args.all:
                    print(f"[skip-existing] {name}")
                    continue
                print(f"[dryrun] {a} x {s} x {m} ...", flush=True)
                shape = SHAPES[s]
                if args.seq_len or args.batch:
                    shape = dataclasses.replace(shape, name=f"{s}_{args.seq_len}x{args.batch}",
                                                seq_len=args.seq_len or shape.seq_len,
                                                global_batch=args.batch or shape.global_batch)
                try:
                    res = run_cell(a, shape, m, seq_parallel=args.seq_parallel,
                                   fsdp=not args.no_fsdp, layout=args.layout,
                                   remat=not args.no_remat,
                                   mesh=_one_mesh() if m == "one" else None)
                except Exception as exc:  # noqa: BLE001
                    failures += 1
                    res = {"arch": a, "shape": s, "mesh": m, "status": "error",
                           "error": f"{type(exc).__name__}: {exc}",
                           "traceback": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                status = res["status"]
                extra = ""
                if status == "ok":
                    r = res["roofline"]
                    frac = r["roofline_fraction"]
                    extra = (f" dominant={r['dominant']}"
                             f" frac={frac if frac is None else round(frac, 3)}"
                             f" mem={res['memory']['peak_bytes'] / 2**30:.2f}GiB"
                             f" trace={res['trace_s']}s")
                elif status == "error":
                    extra = " " + res["error"][:200]
                print(f"[dryrun] {a} x {s} x {m}: {status}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
