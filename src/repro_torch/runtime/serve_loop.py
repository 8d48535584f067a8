"""The continuous-batching LM serving engine on the port's load balancer.

The reference's ``runtime/serve_loop.py`` for one card: prefill and decode
are two balancer tag families (``prefill:<variant>`` and
``decode:<variant>``), and each decode server is a
:class:`~repro_torch.balancer.types.DecodePool` whose slots are the rows of
one batched decode step; ``gen:<variant>`` servers are the
generation-granularity baseline.  Greedy sampling throughout.

Not ported yet (ROADMAP Queue 1 item 10): the paged and speculative modes,
and the sharded per-cell entry points (``shard_prefill_step`` /
``shard_decode_step``), which wait with the sharding layer.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.balancer import (
    DecodeHandoff,
    DecodePool,
    DecodeResult,
    LoadBalancer,
    PromptTooLongError,
    Server,
)
from repro_torch.configs.base import NOT_PORTED, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import ModelBundle, build_model
from repro_torch.models.lm import pool_decode_state, slot_insert

MODES = ("continuous", "generation")


def _device_of(params) -> torch.device:
    return params["embed"].device


def _prompt_tensor(prompt, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prompt, dtype=np.int64).reshape(1, -1), device=device)


def make_prefill_fn(bundle: ModelBundle, params, cache_len: int) -> Callable[[Tuple], DecodeHandoff]:
    """Request handler for a ``prefill:<variant>`` server.

    Theta contract: ``(prompt (1, S) ints, n_new, eos)``.  ``prefill_state``
    produces the last-position logits and the B = 1 decode state; the
    :class:`DecodeHandoff` carries that state and the first greedy token to
    a decode slot.
    """
    device = _device_of(params)

    def prefill(theta) -> DecodeHandoff:
        prompt, n_new, eos = theta
        logits, state = bundle.prefill_state(params, _prompt_tensor(prompt, device), cache_len)
        return DecodeHandoff(
            state=state, token=int(torch.argmax(logits[0, -1])), max_new=int(n_new), eos=eos
        )

    return prefill


def make_decode_pool(
    bundle: ModelBundle,
    params,
    *,
    n_slots: int,
    cache_len: int,
    name: str,
    tag: str,
) -> DecodePool:
    """A :class:`DecodePool` over one batched greedy decode step.

    The pooled state has one row per slot, each at its own position, so one
    decode step advances every occupied slot by a token (the reference
    ``vmap``s a B = 1 step over the slots); the argmax runs on the card and
    only ``(n_slots,)`` token ids come back to the host.
    """
    cfg = bundle.cfg
    device = _device_of(params)

    def step(pool_state, tokens):
        feed = torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=device)[:, None]
        logits, state = bundle.decode_step(params, pool_state, feed)
        return state, torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    return DecodePool(
        step_fn=step,
        insert_fn=lambda st, slot, seq: slot_insert(st, seq, slot),
        init_state_fn=lambda: pool_decode_state(cfg, n_slots, cache_len, device),
        n_slots=n_slots,
        name=name,
        capacity_tags=[tag],
    )


def make_generate_fn(
    bundle: ModelBundle,
    params,
    cache_len: int,
    clock: Callable[[], float] = time.monotonic,
) -> Callable[[Tuple], DecodeResult]:
    """Generation-granularity baseline handler for a ``gen:<variant>`` server:
    the same prefill and greedy sampling as the continuous path, then a
    B = 1 decode loop; the request holds the server for its whole
    generation."""
    device = _device_of(params)

    def generate(theta) -> DecodeResult:
        prompt, n_new, eos = theta
        logits, state = bundle.prefill_state(params, _prompt_tensor(prompt, device), cache_len)
        tokens = [int(torch.argmax(logits[0, -1]))]
        times = [clock()]
        while len(tokens) < int(n_new) and (eos is None or tokens[-1] != eos):
            feed = torch.full((1, 1), tokens[-1], dtype=torch.int64, device=device)
            logits, state = bundle.decode_step(params, state, feed)
            tokens.append(int(torch.argmax(logits[0, -1])))
            times.append(clock())
        return DecodeResult(tokens=np.asarray(tokens, dtype=np.int64), token_times=times)

    return generate


class Generation:
    """Client handle for one generation through the engine.

    In continuous mode it chains the two dispatches: the prefill request's
    completion callback submits the :class:`DecodeHandoff` to the
    ``decode:<variant>`` tag, so the client never blocks between the
    stages.  ``result()`` joins the chain.
    """

    def __init__(self, lb: LoadBalancer, variant: str, theta, mode: str) -> None:
        self._lb = lb
        self.variant = variant
        self.submitted_at = time.monotonic()
        self._result: Optional[DecodeResult] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        if mode == "generation":
            self._lb.submit_async(theta, tag=f"gen:{variant}").add_done_callback(self._on_final)
        else:
            self._lb.submit_async(theta, tag=f"prefill:{variant}").add_done_callback(
                self._on_prefill
            )

    def _on_prefill(self, req) -> None:
        if req.error is not None:
            self._error = req.error
            self._done.set()
            return
        self._lb.submit_async(req.result, tag=f"decode:{self.variant}").add_done_callback(
            self._on_final
        )

    def _on_final(self, req) -> None:
        self._error = req.error
        self._result = req.result
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> DecodeResult:
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def ttft_s(self) -> float:
        """Time from submission to the first token's clock stamp."""
        return self.result().token_times[0] - self.submitted_at


class ServingEngine:
    """Heterogeneous LM serving through the paper's load balancer.

    ``variants`` maps a variant name to its :class:`ArchConfig`; every
    variant gets its own tag family and ``n_replicas`` servers, routed
    within the family by the balancer's ``cost_aware`` policy (default).

    ``mode='continuous'`` builds per-variant ``prefill:<v>`` servers and
    ``decode:<v>`` pools; ``mode='generation'`` builds the ``gen:<v>``
    baseline.  Both take the theta ``(prompt, n_new, eos)`` and sample
    greedily.  ``params`` maps a variant to its port parameters (the tests
    pass the reference engine's weights this way); a variant without them is
    initialised from ``torch.Generator().manual_seed(seed + i)``.
    """

    def __init__(
        self,
        variants: Mapping[str, ArchConfig],
        *,
        mode: str = "continuous",
        kv: str = "slab",
        n_replicas: int = 1,
        n_slots: int = 4,
        cache_len: int = 96,
        policy: str = "cost_aware",
        seed: int = 0,
        exact_telemetry: bool = False,
        device: str = "cuda",
        params: Optional[Mapping[str, object]] = None,
    ) -> None:
        if mode in ("paged", "speculative") or kv == "paged":
            raise NotImplementedError(f"serving mode '{mode}' / kv '{kv}': {NOT_PORTED}")
        if mode not in MODES:
            raise ValueError(f"unknown serving mode '{mode}'")
        if kv != "slab":
            raise ValueError(f"unknown kv layout '{kv}'")
        dev = resolve_device(device)
        self.mode = mode
        self.cache_len = cache_len
        self.variants: Dict[str, ArchConfig] = dict(variants)
        self.bundles: Dict[str, ModelBundle] = {}
        self.params: Dict[str, object] = {}
        servers: List[Server] = []
        for i, (vname, cfg) in enumerate(self.variants.items()):
            bundle = build_model(cfg)
            if params is not None and vname in params:
                p = params[vname]
            else:
                p = bundle.init(torch.Generator().manual_seed(seed + i), dev)
            self.bundles[vname] = bundle
            self.params[vname] = p
            for r in range(n_replicas):
                if mode == "continuous":
                    servers.append(Server(
                        make_prefill_fn(bundle, p, cache_len),
                        name=f"prefill:{vname}#{r}",
                        capacity_tags=[f"prefill:{vname}"],
                    ))
                    servers.append(make_decode_pool(
                        bundle, p, n_slots=n_slots, cache_len=cache_len,
                        name=f"decode:{vname}#{r}", tag=f"decode:{vname}",
                    ))
                else:
                    servers.append(Server(
                        make_generate_fn(bundle, p, cache_len),
                        name=f"gen:{vname}#{r}",
                        capacity_tags=[f"gen:{vname}"],
                    ))
        self.lb = LoadBalancer(servers, policy=policy, exact_telemetry=exact_telemetry)

    # -- client API ----------------------------------------------------------
    def submit(self, variant: str, prompt, n_new: int, *, eos: Optional[int] = None) -> Generation:
        """Submit one generation (non-blocking); join via ``.result()``.

        Raises :class:`PromptTooLongError` when the prompt plus budget can
        never fit ``cache_len`` (the cache would wrap mid-generation).
        """
        if variant not in self.variants:
            raise KeyError(f"unknown variant '{variant}'")
        prompt = np.asarray(prompt, dtype=np.int64)
        need = int(prompt.size) + int(n_new) - 1
        if prompt.size < 1 or need > self.cache_len:
            raise PromptTooLongError(
                f"prompt ({prompt.size}) + n_new ({n_new}) needs {need} "
                f"cache positions; engine cache_len is {self.cache_len}"
            )
        return Generation(self.lb, variant, (prompt, int(n_new), eos), self.mode)

    def summary(self):
        return self.lb.summary()

    def stats_table(self):
        return self.lb.stats_table()

    def shutdown(self) -> None:
        self.lb.shutdown()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def serving_metrics(gens: List[Generation], wall_s: float, summary: Optional[dict] = None) -> dict:
    """Aggregate serving metrics from completed generations.

    ``tokens_per_s`` counts every emitted token against the wall clock;
    ``ttft`` is submission -> first token; ``per_token`` quantiles are over
    inter-token gaps (the decode cadence clients observe).
    """
    results = [g.result() for g in gens]
    n_tokens = int(sum(len(r.tokens) for r in results))
    ttft = [g.ttft_s for g in gens]
    gaps: List[float] = []
    for r in results:
        gaps.extend(np.diff(r.token_times).tolist())
    out = {
        "n_requests": len(gens),
        "n_tokens": n_tokens,
        "wall_s": wall_s,
        "tokens_per_s": n_tokens / wall_s if wall_s > 0 else float("nan"),
        "ttft_mean_s": float(np.mean(ttft)) if ttft else float("nan"),
        "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft else float("nan"),
        "per_token_p50_s": float(np.percentile(gaps, 50)) if gaps else float("nan"),
        "per_token_p99_s": float(np.percentile(gaps, 99)) if gaps else float("nan"),
    }
    occ = (summary or {}).get("slot_occupancy", {})
    if occ:
        out["slot_occupancy"] = {name: round(row["mean"], 4) for name, row in occ.items()}
    return out


# The reference's paged, speculative and sharded entry points, not ported yet.
_REFERENCE_ONLY = (
    "make_paged_decode_pool", "make_speculative_fn", "speculative_supported",
    "shard_prefill_step", "shard_decode_step",
)


def __getattr__(name: str):
    if name in _REFERENCE_ONLY:
        raise NotImplementedError(f"serve_loop.{name}: {NOT_PORTED}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
