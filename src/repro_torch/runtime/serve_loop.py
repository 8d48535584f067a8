"""The continuous-batching LM serving engine on the port's load balancer.

The reference's ``runtime/serve_loop.py`` for one card: prefill and decode
are two balancer tag families (``prefill:<variant>`` and
``decode:<variant>``), and each decode server is a
:class:`~repro_torch.balancer.types.DecodePool` whose slots are the rows of
one batched decode step; ``gen:<variant>`` servers are the
generation-granularity baseline.  Greedy sampling throughout.

``mode='paged'`` serves through :class:`PagedDecodePool` servers, each over
one shared KV block pool, prefilling through the pool in chunks;
``mode='speculative'`` serves ``spec:<variant>`` servers that draft with
the model's own bottom half and verify with the whole model.

Every server decodes through CUDA graphs captured once over static state
(the counterparts of the reference's jitted steps), so a token costs one
replay instead of ~2,700 eager launches: a :class:`DecodeGraph` (the decode
step and its argmax; a prompt replays the B = 1 graph once a position), a
:class:`PagedGraphs` (the paged step, and a chunked-prefill graph for each
padded chunk length), and the speculative verify graphs (k + 1 decode steps
each).

The sharded per-cell entry points (:func:`shard_prefill_step`,
:func:`shard_decode_step`) run the model's prefill and decode step over
DTensors on a ``DeviceMesh``, laid out by the sharding policy;
:func:`graph_prefill_step` and :func:`graph_decode_step` replay them as one
CUDA graph each over placed state (the decode state donated), the
counterparts of the reference's jitted prefill and decode step.
"""
from __future__ import annotations

import threading
import time
from dataclasses import replace
from functools import partial
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.balancer import (
    DecodeHandoff,
    DecodePool,
    DecodeResult,
    LoadBalancer,
    PagedDecodePool,
    PromptTooLongError,
    Server,
)
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.graphs import StaticGraph
from repro_torch.kernels import build
from repro_torch.models import (
    ModelBundle,
    abstract_decode_state,
    abstract_inputs,
    abstract_params,
    build_model,
)
from repro_torch.models.attention import KVCache
from repro_torch.models.lm import (
    DecodeState,
    check_paged_support,
    init_decode_state,
    init_paged_state,
    paged_decode_step,
    paged_prefill_chunk,
    paged_reset_slot,
    slot_insert,
)

from .sharding import (
    ShardingPolicy,
    batch_shardings,
    decode_state_shardings,
    params_shardings,
)
from .train_loop import GraphShardedStep, ShardedStep

MODES = ("continuous", "generation", "paged", "speculative")


def _device_of(params) -> torch.device:
    return params["embed"].device


def _prompt_tensor(prompt, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prompt, dtype=np.int64).reshape(1, -1), device=device)


class DecodeGraph:
    """The greedy decode step over one static decode state of ``batch``
    rows: ``bundle.decode_step`` and the argmax, captured once as a CUDA
    graph (eager on the CPU; see :class:`~repro_torch.graphs.StaticGraph`).

    ``state`` is the static state: the graph reads and writes it in place
    (caches and recurrent state are written by the step itself, its new
    positions copied back into ``state.pos``), so a pool inserts into it
    directly.  A call takes ``(batch, 1)`` tokens and
    returns ``(ids (batch,), logits (batch, 1, V))``.
    """

    def __init__(self, bundle: ModelBundle, params, batch: int, cache_len: int, *,
                 name: str) -> None:
        device = _device_of(params)
        self.state = init_decode_state(bundle.cfg, batch, cache_len, device)

        def step(tokens: torch.Tensor):
            logits, new = bundle.decode_step(params, self.state, tokens)
            self.state.pos.copy_(new.pos)
            return torch.argmax(logits[:, -1], dim=-1), logits

        self.graph = StaticGraph(
            step, [torch.zeros((batch, 1), dtype=torch.int64, device=device)], name=name
        )
        self.reset()  # the capture's eager warm-up ran a step on the state

    def __call__(self, tokens: torch.Tensor):
        return self.graph(tokens)

    def reset(self) -> None:
        """Empty every row, as ``init_decode_state`` makes them: caches,
        recurrent state and positions."""
        kv = self.state.kv
        if kv is not None:
            kv.k.zero_()
            kv.v.zero_()
            kv.pos_buf.fill_(-1)
        if self.state.ssm_h is not None:
            self.state.ssm_h.zero_()
            self.state.ssm_conv.zero_()
        self.state.pos.zero_()

    def prefill(self, prompt: torch.Tensor):
        """From an empty state, one replay per prompt position (``prompt``
        is ``(batch, S)`` on the state's device); the last call's result."""
        self.reset()
        for t in range(prompt.shape[1]):
            out = self(prompt[:, t : t + 1])
        return out

    def snapshot(self) -> DecodeState:
        """A copy of the state that the next request cannot overwrite."""
        kv = self.state.kv

        def clone(t):
            return None if t is None else t.clone()

        return DecodeState(
            kv=None if kv is None else KVCache(kv.k.clone(), kv.v.clone(), kv.pos_buf.clone()),
            pos=self.state.pos.clone(),
            ssm_h=clone(self.state.ssm_h),
            ssm_conv=clone(self.state.ssm_conv),
        )


def _require_prefill_state(bundle: ModelBundle) -> None:
    """Servers prefill from tokens alone: the encoder-decoder, whose decode
    state comes from its frames, is refused with the reference's message."""
    if bundle.prefill_state is None:
        raise ValueError(f"family '{bundle.cfg.family}' has no prefill_state")


def make_prefill_fn(bundle: ModelBundle, params, cache_len: int) -> Callable[[Tuple], DecodeHandoff]:
    """Request handler for a ``prefill:<variant>`` server.

    Theta contract: ``(prompt (1, S) ints, n_new, eos)``.  The server's B = 1
    :class:`DecodeGraph` (captured at its first request) replays over the
    prompt, as ``bundle.prefill_state`` steps eagerly; the
    :class:`DecodeHandoff` carries a snapshot of the state and the first
    greedy token to a decode slot.
    """
    _require_prefill_state(bundle)
    device = _device_of(params)
    graph: Optional[DecodeGraph] = None

    def prefill(theta) -> DecodeHandoff:
        nonlocal graph
        prompt, n_new, eos = theta
        if graph is None:
            graph = DecodeGraph(bundle, params, 1, cache_len, name="prefill B=1")
        ids, _ = graph.prefill(_prompt_tensor(prompt, device))
        return DecodeHandoff(
            state=graph.snapshot(), token=int(ids[0]), max_new=int(n_new), eos=eos
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
    only ``(n_slots,)`` token ids come back to the host.  The pool's state
    is the static state of an ``n_slots``-row :class:`DecodeGraph`,
    captured when the pool first allocates its state: a step is one copy
    of the tokens in, one replay and one copy of the ids out.
    """
    graph: Optional[DecodeGraph] = None

    def init_state() -> DecodeState:
        nonlocal graph
        graph = DecodeGraph(bundle, params, n_slots, cache_len, name=f"decode pool B={n_slots}")
        return graph.state

    def step(pool_state, tokens):
        if pool_state is not graph.state:
            raise ValueError("a decode pool steps only the state its graph was captured over")
        ids, _ = graph(torch.as_tensor(np.asarray(tokens, dtype=np.int64)).reshape(-1, 1))
        return pool_state, ids.cpu().numpy()

    return DecodePool(
        step_fn=step,
        insert_fn=lambda st, slot, seq: slot_insert(st, seq, slot),
        init_state_fn=init_state,
        n_slots=n_slots,
        name=name,
        capacity_tags=[tag],
    )


class PagedGraphs:
    """A paged pool's device state and the CUDA graphs over it (eager on
    the CPU; see :class:`~repro_torch.graphs.StaticGraph`).

    ``state`` is the static :class:`~repro_torch.models.lm.PagedDecodeState`:
    block pool, tables and positions.  ``step(tokens, active)`` (both
    ``(n_slots,)``) replays :func:`~repro_torch.models.lm.paged_decode_step`
    and returns ``(ids (n_slots,), logits (n_slots, 1, V))``;
    ``chunk(slot, tokens, start_pos)`` replays the graph of
    :func:`~repro_torch.models.lm.paged_prefill_chunk` and returns
    ``(id (1,), logits (1, 1, V))`` of the chunk's last token.  Both write
    the new positions into ``state.pos``.  A slot is leased with
    :func:`~repro_torch.models.lm.paged_reset_slot` on ``state``, which
    writes its table row and position in place: no graph holds a slot's
    blocks as a host value.

    Chunk graphs are captured at their first use.  Given ``prefill_chunk``
    (the pool's longest chunk), a KV or layered hybrid model pads a chunk
    of n tokens to the next power of two from 16, at most
    ``prefill_chunk``, so a pool captures at most log2(prefill_chunk / 16)
    + 2 chunk graphs (5 at 256, 1 at 16); otherwise, and always for the
    SSM family, whose chunk steps a token at a time, one graph a chunk
    length.  Each call adds its real tokens to the tally ``prefill
    tokens`` and its padding to ``prefill pad tokens``.
    """

    def __init__(self, bundle: ModelBundle, params, *, n_slots: int, n_blocks: int,
                 block_size: int, cache_len: int, name: str,
                 prefill_chunk: Optional[int] = None) -> None:
        cfg = bundle.cfg
        self.device = _device_of(params)
        self.name = name
        self.prefill_chunk = None if cfg.family == "ssm" else prefill_chunk
        max_blocks = -(-cache_len // block_size)
        # The graphs' functions hold the state, not this object: no reference
        # cycle, so dropping the object frees the graphs and the state.
        state = self.state = init_paged_state(cfg, n_slots, n_blocks + 1, block_size,
                                              max_blocks, cache_len, self.device)

        def step(tokens: torch.Tensor, active: torch.Tensor):
            new, ids, logits = paged_decode_step(params, cfg, state, tokens, active, cache_len)
            state.pos.copy_(new.pos)
            return ids, logits

        def chunk(slot: torch.Tensor, tokens: torch.Tensor, start_pos: torch.Tensor,
                  n_real: Optional[torch.Tensor] = None):
            new, ids, logits = paged_prefill_chunk(params, cfg, state, slot, tokens,
                                                   start_pos, cache_len, n_real)
            state.pos.copy_(new.pos)
            return ids, logits

        self._chunk_fn = chunk
        # The capture's warm-up runs the step with every slot inactive: it
        # writes the scratch row only and moves no position.
        self.step = StaticGraph(step, [
            torch.zeros((n_slots,), dtype=torch.int64, device=self.device),
            torch.zeros((n_slots,), dtype=torch.bool, device=self.device),
        ], name=f"{name} step")
        self.chunks: Dict[int, StaticGraph] = {}

    def padded_length(self, n: int) -> int:
        """The length a chunk of ``n`` tokens runs at."""
        if self.prefill_chunk is None:
            return n
        return min(self.prefill_chunk, max(16, 1 << (n - 1).bit_length()))

    def chunk(self, slot: int, tokens, start_pos: int):
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        n = len(tokens)
        size = self.padded_length(n)
        inputs = [
            torch.tensor(int(slot), dtype=torch.int64),
            torch.as_tensor(np.pad(tokens, (0, size - n))),
            torch.tensor(int(start_pos), dtype=torch.int64),
        ]
        if self.prefill_chunk is not None:
            inputs.append(torch.tensor(n, dtype=torch.int64))
        build.tally("prefill tokens").add(n)
        build.tally("prefill pad tokens").add(size - n)
        graph = self.chunks.get(size)
        if graph is None:
            # Captured on this call's own inputs: the warm-up writes the
            # chunk's keys and values, and the replay below writes the same
            # ones again.  A recurrent state is not rewritten but advanced,
            # so the slot's is put back after the warm-up.
            st = self.state
            saved = None if st.ssm_h is None else (st.ssm_h[:, slot].clone(),
                                                   st.ssm_conv[:, slot].clone())
            graph = self.chunks[size] = StaticGraph(
                self._chunk_fn, [x.to(self.device) for x in inputs],
                name=f"{self.name} chunk C={size}",
            )
            if saved is not None:
                st.ssm_h[:, slot] = saved[0]
                st.ssm_conv[:, slot] = saved[1]
        return graph(*inputs)


def make_paged_decode_pool(
    bundle: ModelBundle,
    params,
    *,
    n_slots: int,
    cache_len: int,
    block_size: int = 16,
    n_blocks: Optional[int] = None,
    prefill_chunk: int = 16,
    name: str,
    tag: str,
) -> PagedDecodePool:
    """A :class:`PagedDecodePool` over the block-table decode path.

    The device state is one shared ``(L, n_blocks + 1, block_size, Hkv,
    hd)`` KV pool (row 0 is scratch) and per-slot block tables; requests
    carry raw ``(prompt, n_new, eos)`` thetas and are prefilled *through
    the pool*, ``prefill_chunk`` positions per token boundary.  ``n_blocks``
    is the usable block count; None provisions ``n_slots`` worst-case
    sequences.  The pool's state is a :class:`PagedGraphs`, made when the
    pool first allocates its state, and only the pool holds it: a step is
    one copy of tokens and mask in, one replay and one copy of the
    ``(n_slots,)`` ids out; a prompt's last, shorter chunk is padded.  An
    SSM pool holds 0 blocks: its state is the slots' recurrent state, and
    only chunked prefill remains.
    """
    check_paged_support(bundle.cfg, cache_len)
    max_blocks = -(-cache_len // block_size)
    if bundle.cfg.family == "ssm":
        n_blocks = 0
    elif n_blocks is None:
        n_blocks = n_slots * max_blocks

    def init_state() -> PagedGraphs:
        return PagedGraphs(bundle, params, n_slots=n_slots, n_blocks=n_blocks,
                           block_size=block_size, cache_len=cache_len, name=name,
                           prefill_chunk=prefill_chunk)

    def step_fn(graphs: PagedGraphs, tokens, active):
        ids, _ = graphs.step(torch.as_tensor(np.asarray(tokens, dtype=np.int64)),
                             torch.as_tensor(np.asarray(active, dtype=bool)))
        return graphs, ids.cpu().numpy()

    def chunk_fn(graphs: PagedGraphs, slot, chunk, start_pos):
        ids, _ = graphs.chunk(slot, chunk, start_pos)
        return graphs, int(ids[0])

    def reset_fn(graphs: PagedGraphs, slot, row):
        paged_reset_slot(graphs.state, slot, row)
        return graphs

    return PagedDecodePool(
        step_fn,
        chunk_fn,
        reset_fn,
        init_state_fn=init_state,
        n_slots=n_slots,
        n_blocks=n_blocks,
        block_size=block_size,
        max_blocks_per_slot=max_blocks,
        max_positions=cache_len,
        prefill_chunk=prefill_chunk,
        name=name,
        capacity_tags=[tag],
    )


def speculative_supported(cfg: ArchConfig, cache_len: int) -> bool:
    """Self-speculative decoding needs a KV family (the verify step rewinds
    ``pos`` and relies on the stale entries past it being masked; a
    recurrent state cannot rewind) and a cache that never wraps."""
    return cfg.family in ("dense", "moe", "vlm") and (
        cfg.sliding_window is None or cfg.sliding_window >= cache_len)


def make_speculative_fn(
    bundle: ModelBundle,
    params,
    cache_len: int,
    *,
    spec_k: int = 4,
    draft_layers: Optional[int] = None,
    clock: Callable[[], float] = time.monotonic,
    on_round: Optional[Callable[[int, int], None]] = None,
) -> Callable[[Tuple], DecodeResult]:
    """Greedy self-speculative handler for a ``spec:<variant>`` server.

    The draft is the model's own bottom ``draft_layers`` blocks (default
    ``n_layers // 2``): a list slice of the same weight tensors.  A round:
    the draft proposes ``spec_k`` tokens, each fed back on the card; the
    target verifies them in one replay of a graph of ``k + 1`` decode steps
    (one graph per k in 0..``spec_k``) and the accepted prefix is emitted.
    Each verify step is the B = 1 step of generation mode on the same
    values, so the tokens are generation mode's.  Target and draft each
    have a B = 1 :class:`DecodeGraph` (the prompt and the draft's steps).

    Across rounds the target rewinds ``pos`` to the last verified position
    (stale entries past it are masked by ``pos_buf <= pos``, which holds
    while the cache never wraps); the draft keeps ``draft_ok``, how many of
    its consumed feeds were true tokens, and catches up from there.
    ``on_round(accepted, drafted)`` feeds the accept-rate telemetry.
    """
    cfg = bundle.cfg
    if not speculative_supported(cfg, cache_len):
        raise ValueError(f"speculative decoding needs a KV family (not {cfg.family!r}) and "
                         f"sliding_window >= cache_len ({cfg.sliding_window} < {cache_len})")
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    d_layers = draft_layers if draft_layers is not None else max(1, cfg.n_layers // 2)
    if not 1 <= d_layers <= cfg.n_layers:
        raise ValueError(f"draft_layers {d_layers} out of range")
    d_bundle = build_model(replace(cfg, n_layers=d_layers))
    d_params = {**params, "blocks": params["blocks"][:d_layers]}
    device = _device_of(params)
    graphs: Optional[Tuple[DecodeGraph, DecodeGraph, List[StaticGraph]]] = None

    def verify_graph(target: DecodeGraph, k: int) -> StaticGraph:
        def verify(feeds: torch.Tensor) -> torch.Tensor:  # (k + 1,): last token + k drafts
            ids = []
            for i in range(k + 1):
                feed = feeds[i : i + 1].reshape(1, 1)
                logits, new = bundle.decode_step(params, target.state, feed)
                target.state.pos.copy_(new.pos)
                ids.append(torch.argmax(logits[:, -1], dim=-1))
            return torch.cat(ids)

        return StaticGraph(verify, [torch.zeros((k + 1,), dtype=torch.int64, device=device)],
                           name=f"spec verify k={k}")

    def generate(theta) -> DecodeResult:
        nonlocal graphs
        prompt, n_new, eos = theta
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        s_len, n_new = len(prompt), int(n_new)
        if graphs is None:
            target = DecodeGraph(bundle, params, 1, cache_len, name="spec target B=1")
            graphs = (target, DecodeGraph(d_bundle, d_params, 1, cache_len, name="spec draft B=1"),
                      [verify_graph(target, k) for k in range(spec_k + 1)])
        target, draft, verify = graphs
        # The prefill resets the state, also of what the verify captures wrote.
        ids, _ = target.prefill(_prompt_tensor(prompt, device))
        tokens = [int(ids[0])]
        times = [clock()]
        draft.prefill(_prompt_tensor(prompt, device))
        draft_ok = s_len  # leading draft feeds that were true tokens
        while len(tokens) < n_new and (eos is None or tokens[-1] != eos):
            t_len = len(tokens)
            # Clamp so the verify steps never write past the cache or the
            # budget; k may reach 0 (a round of one plain step).
            k = max(0, min(spec_k, cache_len - (s_len + t_len), n_new - t_len - 1))
            # Draft catch-up: the true feeds it has not consumed, at least
            # one (seq[s + t - 1], whose output is the first draft).
            seq = prompt.tolist() + tokens
            draft.state.pos.fill_(draft_ok)
            for f in seq[draft_ok : s_len + t_len]:
                d_ids, _ = draft(torch.full((1, 1), f, dtype=torch.int64))
            drafts = []
            while len(drafts) < k:
                drafts.append(d_ids)
                if len(drafts) < k:
                    d_ids, _ = draft(d_ids.reshape(1, 1))
            feeds = torch.cat([torch.full((1,), tokens[-1], dtype=torch.int64, device=device),
                               *drafts])
            greedy = verify[k](feeds).cpu().numpy()
            proposed = feeds[1:].cpu().numpy()
            accepted = 0
            while accepted < k and int(proposed[accepted]) == int(greedy[accepted]):
                accepted += 1
            if on_round is not None and k > 0:
                on_round(accepted, k)
            now = clock()
            stop = False
            for g in greedy[: accepted + 1]:
                tokens.append(int(g))
                times.append(now)
                if len(tokens) >= n_new or (eos is not None and int(g) == eos):
                    stop = True
                    break
            if stop:
                break
            # Rewind past the first wrong feed: the valid feeds were the last
            # emitted token and the accepted drafts.
            target.state.pos.fill_(s_len + t_len + accepted)
            # The draft consumed drafts[:-1]; its true prefix grows by the
            # accepted ones it ate.
            draft_ok = s_len + t_len + min(accepted, max(k - 1, 0))
        return DecodeResult(tokens=np.asarray(tokens, dtype=np.int64), token_times=times)

    return generate


def make_generate_fn(
    bundle: ModelBundle,
    params,
    cache_len: int,
    clock: Callable[[], float] = time.monotonic,
) -> Callable[[Tuple], DecodeResult]:
    """Generation-granularity baseline handler for a ``gen:<variant>`` server:
    the same prefill and greedy sampling as the continuous path, then a
    B = 1 decode loop; the request holds the server for its whole
    generation.  Prompt and generation replay the server's B = 1
    :class:`DecodeGraph`, each new token fed back on the card."""
    _require_prefill_state(bundle)
    device = _device_of(params)
    graph: Optional[DecodeGraph] = None

    def generate(theta) -> DecodeResult:
        nonlocal graph
        prompt, n_new, eos = theta
        if graph is None:
            graph = DecodeGraph(bundle, params, 1, cache_len, name="generate B=1")
        ids, _ = graph.prefill(_prompt_tensor(prompt, device))
        tokens = [int(ids[0])]
        times = [clock()]
        while len(tokens) < int(n_new) and (eos is None or tokens[-1] != eos):
            ids, _ = graph(ids.reshape(1, 1))
            tokens.append(int(ids[0]))
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

    # The single-dispatch modes and the tag family each submits to;
    # continuous (slab) is the one two-stage mode.
    _SINGLE_TAGS = {"generation": "gen", "paged": "prefill", "speculative": "spec"}

    def __init__(self, lb: LoadBalancer, variant: str, theta, mode: str) -> None:
        self._lb = lb
        self.variant = variant
        self.submitted_at = time.monotonic()
        self._result: Optional[DecodeResult] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        if mode in self._SINGLE_TAGS:
            tag = f"{self._SINGLE_TAGS[mode]}:{variant}"
            self._lb.submit_async(theta, tag=tag).add_done_callback(self._on_final)
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
    baseline; ``mode='paged'`` (or ``kv='paged'`` with continuous) builds a
    :class:`PagedDecodePool` under ``prefill:<v>`` that prefills through its
    block pool (``block_size``, ``n_blocks``, ``prefill_chunk``);
    ``mode='speculative'`` builds ``spec:<v>`` servers (``spec_k``,
    ``spec_draft_layers``).  All take the theta ``(prompt, n_new, eos)``
    and sample greedily.  ``params`` maps a variant to its port parameters (the tests
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
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        prefill_chunk: int = 16,
        spec_k: int = 4,
        spec_draft_layers: Optional[int] = None,
        policy: str = "cost_aware",
        seed: int = 0,
        exact_telemetry: bool = False,
        device: str = "cuda",
        params: Optional[Mapping[str, object]] = None,
    ) -> None:
        if mode not in MODES:
            raise ValueError(f"unknown serving mode '{mode}'")
        if kv not in ("slab", "paged"):
            raise ValueError(f"unknown kv layout '{kv}'")
        if mode == "continuous" and kv == "paged":
            mode = "paged"  # paged is continuous batching over the block pool
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
                elif mode == "paged":
                    # One pool a replica: prefill runs through it in chunks,
                    # so the prefill tag routes straight here.
                    servers.append(make_paged_decode_pool(
                        bundle, p, n_slots=n_slots, cache_len=cache_len,
                        block_size=block_size, n_blocks=n_blocks, prefill_chunk=prefill_chunk,
                        name=f"paged:{vname}#{r}", tag=f"prefill:{vname}",
                    ))
                elif mode == "speculative":
                    if speculative_supported(cfg, cache_len):
                        fn = make_speculative_fn(
                            bundle, p, cache_len, spec_k=spec_k, draft_layers=spec_draft_layers,
                            on_round=partial(self._record_spec, f"spec:{vname}"),
                        )
                    else:
                        # A recurrent state or a cache that wraps cannot
                        # rewind: serve plain greedy under the spec tag, so
                        # a mixed zoo still takes one workload.
                        fn = make_generate_fn(bundle, p, cache_len)
                    servers.append(Server(fn, name=f"spec:{vname}#{r}",
                                          capacity_tags=[f"spec:{vname}"]))
                else:
                    servers.append(Server(
                        make_generate_fn(bundle, p, cache_len),
                        name=f"gen:{vname}#{r}",
                        capacity_tags=[f"gen:{vname}"],
                    ))
        self.lb = LoadBalancer(servers, policy=policy, exact_telemetry=exact_telemetry)

    def _record_spec(self, tag: str, accepted: int, drafted: int) -> None:
        self.lb.telemetry.record_spec(tag, accepted, drafted)

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
        """Stop the balancer and free the decode pools' device state now: the
        balancer sits in reference cycles, so without this the state would
        stay on the card until the next cyclic collection, under the feet
        of whatever uses the card next."""
        self.lb.shutdown()
        for server in self.lb.servers:
            if isinstance(server, DecodePool):
                server.drop_state()

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
    summary = summary or {}
    for key in ("slot_occupancy", "block_occupancy"):
        if summary.get(key):
            out[key] = {name: round(row["mean"], 4) for name, row in summary[key].items()}
    if summary.get("spec_accept"):
        out["spec_accept"] = {
            tag: {"rate": round(row["rate"], 4), "rounds": row["rounds"],
                  "accepted": row["accepted"], "drafted": row["drafted"]}
            for tag, row in summary["spec_accept"].items()
        }
    return out


# ---------------------------------------------------------------------------
# The sharded per-cell entry points
# ---------------------------------------------------------------------------
def shard_prefill_step(cfg: ArchConfig, shape: ShapeConfig, policy: ShardingPolicy):
    """The prefill over a ``DeviceMesh``: ``fn(params, batch)`` -> the
    last-position logits (B, 1, V) as a DTensor, with the config's
    attention (the flash kernel on the card, on each rank's shards), under
    ``activation_sharding(policy)``.  Returns ``(fn, (params_abs,
    batch_abs))``, the abstract values ``meta`` tensors."""
    bundle = build_model(cfg)
    params_abs = abstract_params(cfg)
    batch_abs = abstract_inputs(cfg, shape)
    p_sh = params_shardings(policy, params_abs, cfg)
    b_sh = batch_shardings(policy, batch_abs)
    return ShardedStep(bundle.prefill, policy, (p_sh, b_sh)), (params_abs, batch_abs)


def shard_decode_step(cfg: ArchConfig, shape: ShapeConfig, policy: ShardingPolicy):
    """One decode step over a ``DeviceMesh``: ``fn(params, state, batch)``
    -> (logits (B, 1, V), state), ``batch = {"tokens": (B, 1)}``.

    The state is laid out by ``decode_state_shardings`` (the cache's W on
    the model axis where the KV heads do not divide it) and written in
    place, each rank writing the new entries that fall in its shard (the
    reference donates the state); no activation constraints, as in the
    reference.  Returns ``(fn, (params_abs, state_abs, tokens_abs))``."""
    bundle = build_model(cfg)
    params_abs = abstract_params(cfg)
    state_abs = abstract_decode_state(cfg, shape)
    tokens_abs = abstract_inputs(cfg, shape)  # {"tokens": (B, 1)}
    p_sh = params_shardings(policy, params_abs, cfg)
    s_sh = decode_state_shardings(policy, state_abs)
    t_sh = batch_shardings(policy, tokens_abs)

    def step(params, state, batch):
        return bundle.decode_step(params, state, batch["tokens"])

    return (ShardedStep(step, policy, (p_sh, s_sh, t_sh), constrain=False),
            (params_abs, state_abs, tokens_abs))


def graph_prefill_step(fn: ShardedStep, params, *, name: str) -> GraphShardedStep:
    """:func:`shard_prefill_step`'s step as one graph over placed
    parameters, nothing donated: ``step({"tokens": ...})`` -> the
    last-position logits as a DTensor (a clone)."""
    return GraphShardedStep(fn, params, name=name)


def graph_decode_step(fn: ShardedStep, params, state: DecodeState, *,
                      name: str) -> GraphShardedStep:
    """:func:`shard_decode_step`'s step as one graph over placed parameters
    and a donated decode state (``donate_argnums=(1,)``): ``step({"tokens":
    (B, 1)})`` -> the logits as a DTensor (a clone), the new state written
    into ``step.args[1]``'s leaves in place."""
    return GraphShardedStep(fn, params, state, donate={1: 1}, output=0, name=name)
