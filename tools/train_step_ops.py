"""Count the host operations of one train step, by part, on the CPU.

    PYTHONPATH=src python tools/train_step_ops.py [--arch smollm-360m]

The train step of ``repro_torch.runtime.train_loop`` at the arch's depth
(its layer count and block structure) but narrow widths, so it runs in
seconds: the number of top-level ``aten::`` operations (those not called
by another) that the forward, the forward with remat's second forward and
the backward, and the AdamW update issue, and the most frequent ones.  An
eager step on the card launches at least one kernel for most of these, so
the count is what the host must issue a step whatever the widths.  A CPU
count; no device time.
"""
from __future__ import annotations

import argparse
import dataclasses
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.data import synthetic_lm_batch
from repro_torch.models import build_model
from repro_torch.optim.adamw import make_adamw
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime.train_loop import TrainRuntime, make_grad_fn, training_config


def top_level_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events() if e.name.startswith("aten::")
                   and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    args = ap.parse_args()
    full = get_arch(args.arch)
    cfg = dataclasses.replace(full.reduced(), n_layers=full.n_layers, remat=full.remat,
                              shared_attn_every=full.shared_attn_every)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = synthetic_lm_batch(cfg, ShapeConfig("ops", 64, 2, "train"), 0, device="cpu")
    rt = TrainRuntime()
    grad_fn = make_grad_fn(cfg, rt)
    init, update = make_adamw(rt.adamw)
    state = init(params)
    _, grads = grad_fn(params, batch)
    loss = build_model(training_config(cfg)).loss
    parts = {"forward": lambda: loss(params, batch),
             "forward, remat and backward": lambda: grad_fn(params, batch),
             "AdamW update": lambda: update(grads, state, params)}
    print(f"{args.arch}: {cfg.n_layers} layers, remat {cfg.remat}, "
          f"{len(tree_leaves(params))} parameter "
          "leaves; top-level host operations of one train step (CPU):")
    for name, fn in parts.items():
        ops = top_level_ops(fn)
        print(f"  {name}: {sum(ops.values())}; most frequent "
              + ", ".join(f"{k[6:]} {n}" for k, n in ops.most_common(6)))


if __name__ == "__main__":
    main()
