"""Serving entry point: continuous-batching LM serving through the load balancer.

``python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 24``

``--arch`` takes any id of ``repro_torch.configs.ARCHS`` but the
encoder-decoder whisper-large-v3, which the engine refuses (its decode
state comes from audio frames, not a token prompt): the dense qwen2-0.5b,
smollm-360m, phi4-mini-3.8b and nemotron-4-340b, the MoE
granite-moe-3b-a800m and mixtral-8x22b, the VLM llava-next-mistral-7b
(served on text alone, as the reference serves it), the SSM mamba2-1.3b
and the hybrid zamba2-1.2b.

Prefill and decode are two balancer tag families routed ``cost_aware``
across replicas, and each decode server is a slot pool that admits
requests into the in-flight batch at token boundaries.  ``--mode
generation`` runs the request-per-generation baseline, ``--kv paged`` (or
``--mode paged``) the block-table pool with chunked prefill, and ``--mode
speculative`` greedy self-speculative decoding; every mode emits the same
greedy tokens.  The SSM family's paged pool holds no blocks (chunked
prefill into its recurrent state), the hybrid's is refused, and both
serve plain greedy under ``--mode speculative``.  The reduced config is the default; ``--no-reduced``
serves the full-width model (on the card).  ``--device cpu`` runs the
plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.configs import ARCHS, get_arch
from repro_torch.runtime.serve_loop import ServingEngine, serving_metrics


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", default=None,
                    help=f"model variant(s) of {sorted(ARCHS)}; repeat for a heterogeneous pool")
    # The reference's flag is store_true with default True, so its full
    # config cannot be asked for; here --no-reduced serves the full width.
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--mode", choices=["continuous", "generation", "paged", "speculative"],
                    default="continuous")
    ap.add_argument("--kv", choices=["slab", "paged"], default="slab",
                    help="decode-pool KV layout; --kv paged upgrades --mode continuous "
                    "to the block-table pool")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=96)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=None,
                    help="usable KV blocks in the paged pool (default: fully provision "
                    "--slots worst-case sequences)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    names = args.arch or ["qwen2-0.5b"]
    variants = {n: (get_arch(n).reduced() if args.reduced else get_arch(n)) for n in names}
    if args.mode == "continuous" and args.kv == "paged":
        args.mode = "paged"  # the engine's own promotion
    rng = np.random.default_rng(args.seed)
    engine = ServingEngine(
        variants, mode=args.mode, kv=args.kv, n_replicas=args.replicas,
        n_slots=args.slots, cache_len=args.cache_len, block_size=args.block_size,
        n_blocks=args.blocks, prefill_chunk=args.prefill_chunk, spec_k=args.spec_k,
        seed=args.seed, device=args.device,
    )
    with engine:
        # Warm up (allocator, library handles) so the window is steady state.
        for vname, cfg in variants.items():
            warm = rng.integers(0, cfg.vocab, size=(1, args.prompt_len))
            engine.submit(vname, warm, 2).result(timeout=600)

        # Open-loop load: every client submits up front; generation lengths
        # span two orders of magnitude.
        t0 = time.monotonic()
        gens = []
        for _ in range(args.requests):
            vname = names[int(rng.integers(len(names)))]
            n_new = int(rng.choice([1, 4, 16, 64], p=[0.4, 0.3, 0.2, 0.1]))
            prompt = rng.integers(0, variants[vname].vocab, size=(1, args.prompt_len))
            gens.append(engine.submit(vname, prompt, n_new))
        for g in gens:
            g.result(timeout=600)
        wall = time.monotonic() - t0

        m = serving_metrics(gens, wall, engine.summary())
        tag = f"[serve:{args.mode}:{args.device}]"
        print(f"{tag} {m['n_requests']} requests, {m['n_tokens']} tokens "
              f"in {wall:.3f}s -> {m['tokens_per_s']:.1f} tok/s")
        print(f"{tag} ttft mean={m['ttft_mean_s'] * 1e3:.2f}ms "
              f"p99={m['ttft_p99_s'] * 1e3:.2f}ms; per-token "
              f"p50={m['per_token_p50_s'] * 1e3:.2f}ms p99={m['per_token_p99_s'] * 1e3:.2f}ms")
        for name, occ in m.get("slot_occupancy", {}).items():
            print(f"{tag}   {name}: mean slot occupancy {occ:.2f}")
        for name, occ in m.get("block_occupancy", {}).items():
            print(f"{tag}   {name}: mean block occupancy {occ:.2f}")
        for stag, sp in m.get("spec_accept", {}).items():
            print(f"{tag}   {stag}: spec accept rate {sp['rate']:.2f} "
                  f"({sp['accepted']}/{sp['drafted']} over {sp['rounds']} rounds)")
        for row in engine.stats_table():
            print(f"{tag}   {row['tag']}: {row['n_done']} done, "
                  f"{row['tokens']} pooled tokens, ewma {row['ewma_s'] * 1e3:.2f}ms")
        m["tokens"] = [g.result().tokens for g in gens]
        return m


if __name__ == "__main__":
    main()
