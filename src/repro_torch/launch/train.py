"""Training launcher: ``python -m repro_torch.launch.train --arch smollm-360m ...``

Runs real steps on one device with the train-step factory
(``runtime.train_loop``): the config system, the synthetic Markov data
pipeline, AdamW with its schedule and clipping, microbatches, and
checkpoint/restart (``--checkpoint``, ``--resume``; saves in the
background every ``--checkpoint-every`` steps).  The flags and the
``[train] step ...`` log line are the reference's; ``--device`` is the
port's (the card by default, ``cpu`` on request).

One process runs the unsharded step as one CUDA graph a step over donated
state (``train_loop.GraphTrainStep``, the reference's ``jax.jit(train_step,
donate_argnums=(0, 1))``; eager on the CPU).  Launched with a world size above 1
(``torchrun``), every process joins the process group (NCCL on cards, gloo
on the CPU), builds the host mesh ``(world_size, 1)``, and trains through
``shard_train_step`` under the pure-DP policy, as the reference's launcher
does, replayed as one CUDA graph a step over the donated DTensor state
(``train_loop.graph_train_step``, the reference's pjit'd step; eager on
gloo); rank 0 prints and writes the checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --device cpu --steps 20 --batch 8

In code, :func:`make_trainer` builds the model, optimizer and data of a
run and :class:`Trainer` takes its steps; :func:`run` is the loop the CLI
drives.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, restore, save
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import microbatch, synthetic_lm_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import tree_leaves, tree_unflatten
from repro_torch.runtime.train_loop import (
    GraphTrainStep,
    TrainRuntime,
    graph_train_step,
    make_train_fns,
    microbatched_runtime,
    shard_train_step,
)


@dataclass
class Trainer:
    """One training run's model, optimizer state and data stream.

    ``train_step`` is a :class:`GraphTrainStep` in one process, or a
    ``train_loop.GraphShardedStep`` over DTensors (``sharded``); either owns
    ``params`` and ``opt_state`` and writes them in place.  ``params`` and
    ``opt_state`` are the live leaves that the next step overwrites: a
    caller who keeps them must clone them."""

    cfg: ArchConfig
    shape: ShapeConfig
    rt: TrainRuntime
    train_step: Callable
    params: Any
    opt_state: Any
    device: torch.device
    seed: int = 0
    rank: int = 0
    # Whether the leaves are DTensors (a world size above 1).
    sharded: bool = False

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch (a pure function of (seed, step)), in the
        microbatch layout."""
        b = synthetic_lm_batch(self.cfg, self.shape, step, seed=self.seed, device=self.device)
        return microbatch(b, self.rt.microbatches)

    def step(self, step: int) -> Dict[str, torch.Tensor]:
        """One update on step ``step``'s batch -> its metrics (0-d tensors)."""
        return self.train_step(self.batch(step))

    @property
    def state(self):
        """``(params, opt_state)``, whole (a sharded run gathers its shards
        on every rank: call it on all of them); in one process the live
        leaves."""
        if not self.sharded:
            return (self.params, self.opt_state)
        leaves = tree_leaves((self.params, self.opt_state))
        return tree_unflatten((self.params, self.opt_state), [t.full_tensor() for t in leaves])

    def restore(self, path: str) -> int:
        """Load ``(params, opt_state)`` from ``path`` -> the step it was
        saved at."""
        (params, opt_state), step, _ = restore(path, self.state, device=self.device)
        self.train_step.load(params, opt_state)
        return step


def make_trainer(cfg: ArchConfig, *, steps: int, seq_len: int = 256, batch: int = 8,
                 microbatches: int = 1, lr: float = 3e-4, device: DeviceLike = "cuda",
                 seed: int = 0) -> Trainer:
    """A run of ``steps`` steps: AdamW at ``lr`` with the reference's
    launcher's warmup (``max(steps // 20, 5)``) and cosine over ``steps``,
    weights drawn from ``seed`` on ``device``, trained through one
    :class:`GraphTrainStep` (captured at the first step)."""
    dev = resolve_device(device)
    shape = ShapeConfig("cli", seq_len=seq_len, global_batch=batch, kind="train")
    rt = TrainRuntime(
        microbatches=microbatches,
        adamw=AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps),
    )
    init_fn, _ = make_train_fns(cfg, rt)
    params, opt_state = init_fn(torch.Generator(device=dev).manual_seed(seed), dev)
    step = GraphTrainStep(cfg, rt, params, opt_state, name=f"train step {cfg.arch_id}")
    return Trainer(cfg, shape, rt, step, params, opt_state, dev, seed)


def make_sharded_trainer(cfg: ArchConfig, *, steps: int, seq_len: int = 256, batch: int = 8,
                         microbatches: int = 1, lr: float = 3e-4, device: DeviceLike = "cuda",
                         seed: int = 0) -> Trainer:
    """:func:`make_trainer` on every rank of the running process group:
    the host mesh, the pure-DP policy and ``shard_train_step``, the same
    weights on every rank, placed by the step's shardings and donated to
    one ``train_loop.GraphShardedStep`` (captured at the first step on the card,
    replayed at every later one; eager on gloo)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.sharding import make_policy

    plain = make_trainer(cfg, steps=steps, seq_len=seq_len, batch=batch,
                         microbatches=microbatches, lr=lr, device=device, seed=seed)
    policy = make_policy(make_host_mesh(plain.device.type), pure_dp=True)
    rt = microbatched_runtime(plain.rt, plain.shape, policy)
    fn, _ = shard_train_step(cfg, plain.shape, policy, rt)
    step = graph_train_step(fn, plain.params, plain.opt_state,
                            name=f"train step sharded {cfg.arch_id}")
    params, opt_state = step.args
    return Trainer(cfg, plain.shape, rt, step, params, opt_state, plain.device, seed,
                   rank=dist.get_rank(), sharded=True)


def run(trainer: Trainer, start_step: int, steps: int, *, checkpoint: str = "",
        checkpoint_every: int = 50, log_every: int = 10) -> Optional[Dict[str, float]]:
    """Steps ``start_step .. steps - 1``, logging as the reference's
    launcher and saving every ``checkpoint_every`` steps in the background
    and once at the end -> the last step's metrics (None if no step ran)."""
    ckpt = AsyncCheckpointer()
    tokens_per_step = trainer.shape.global_batch * trainer.shape.seq_len
    t0 = time.time()
    metrics = None
    for step in range(start_step, steps):
        metrics = trainer.step(step)
        if trainer.rank == 0 and ((step + 1) % log_every == 0 or step == start_step):
            dt = time.time() - t0
            tps = tokens_per_step * (step + 1 - start_step) / max(dt, 1e-9)
            print(
                f"[train] step {step + 1}/{steps} loss={float(metrics['loss']):.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.2f} "
                f"tok/s={tps:,.0f}",
                flush=True,
            )
        if checkpoint and (step + 1) % checkpoint_every == 0:
            state = trainer.state
            if trainer.rank == 0:
                ckpt.save(checkpoint, state, step=step + 1)
    ckpt.wait()
    if checkpoint:
        state = trainer.state
        if trainer.rank == 0:
            save(checkpoint, state, step=steps)
            print(f"[train] final checkpoint at {checkpoint}")
    return None if metrics is None else {k: float(v) for k, v in metrics.items()}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m", help=f"one of {sorted(ARCHS)}")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized model")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict[str, float]]:
    args = build_parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    kw = dict(steps=args.steps, seq_len=args.seq_len, batch=args.batch,
              microbatches=args.microbatches, lr=args.lr)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        trainer = make_trainer(cfg, device=args.device, **kw)
    else:
        import torch.distributed as dist

        device = resolve_device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        # torchrun's environment gives the address, world size and rank.
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        trainer = make_sharded_trainer(cfg, device=device, **kw)
    try:
        start_step = 0
        if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
            start_step = trainer.restore(args.checkpoint)
            if trainer.rank == 0:
                print(f"[train] resumed from step {start_step}")
        return run(trainer, start_step, args.steps, checkpoint=args.checkpoint,
                   checkpoint_every=args.checkpoint_every, log_every=args.log_every)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
