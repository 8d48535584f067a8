"""Shared value types of the balancer package: servers and requests.

These are the paper's nouns (Section 2.2): a *server* is a persistent model
endpoint with arrival/departure bookkeeping; a *request* is one forward-solve
with the timestamps the paper records for Figs. 8-9.  They carry no
scheduling logic — that lives in :mod:`repro_torch.balancer.policies` — and no
execution logic — that lives in :mod:`repro_torch.balancer.dispatcher`.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ServerStats:
    """Arrival/departure bookkeeping, as recorded by the paper's servers.

    Mutated only by :class:`repro_torch.balancer.telemetry.Telemetry` (under its
    lock); read freely for reporting.
    """

    # one (start, end, tag) row per completed dispatch — a single log so a
    # lock-free reader can snapshot intervals and tags in one atomic
    # list(...) call with no risk of cross-ring misalignment
    busy_log: List[Tuple[float, float, str]] = field(default_factory=list)
    n_requests: int = 0
    n_failures: int = 0
    busy_s: float = 0.0  # running total; survives the busy_log ring buffer

    @property
    def busy_intervals(self) -> List[Tuple[float, float]]:
        log = list(self.busy_log)  # atomic snapshot (single C call)
        return [(a, b) for a, b, _ in log]

    @property
    def tags(self) -> List[str]:
        log = list(self.busy_log)
        return [t for _, _, t in log]

    def uptime(self) -> float:
        """Total busy seconds.  Kept as a running sum so it stays exact in
        streaming-telemetry mode, where ``busy_log`` is a bounded ring
        holding only the most recent intervals."""
        return self.busy_s


class Server:
    """A persistent model server.

    ``fn`` is the request handler (e.g. a :class:`repro_torch.core.model.TorchModel`
    or any callable).  ``capacity_tags`` restricts which request tags this
    server accepts (mirrors heterogeneous pools: fine-PDE servers vs GP
    servers).  Empty means 'accepts everything' — the paper's single-pool
    round-robin default.
    """

    _ids = itertools.count()
    # Continuous-batching servers (DecodePool) take the dispatcher's
    # token-boundary dispatch edge instead of fn/batch_call.
    continuous = False
    # Remote servers (repro_torch.net) evaluate across a socket: the dispatcher
    # splits their completions into wire time vs remote service time using
    # last_service_s (the shell-reported handler seconds of the most
    # recent call — safe as a plain attribute because a server is driven
    # by exactly one worker at a time).
    remote = False
    last_service_s: Optional[float] = None

    def __init__(
        self,
        fn: Callable,
        *,
        name: Optional[str] = None,
        capacity_tags: Sequence[str] = (),
        batch_fn: Optional[Callable] = None,
    ) -> None:
        self.id = next(Server._ids)
        self.name = name or f"server-{self.id}"
        self.fn = fn
        self.batch_fn = batch_fn
        self.capacity_tags = frozenset(capacity_tags)
        self.busy = False
        self.dead = False
        # live -> quarantined -> probation -> live (or retired, terminal).
        # ``dead`` stays the dispatcher-visible admission flag; lifecycle
        # records *why* and whether the health monitor may re-admit.
        self.lifecycle = "live"
        self.stats = ServerStats()
        self.last_free_at: float = time.monotonic()

    def accepts(self, tag: str) -> bool:
        return (not self.capacity_tags) or (tag in self.capacity_tags)

    def probe(self) -> bool:
        """Health probe: is this server able to serve right now?

        The in-process default is a no-op returning True — a live Python
        object can always answer.  Remote servers override this with a
        heartbeat frame across their transport, and the chaos harness
        (:mod:`repro_torch.balancer.faults`) shadows it to keep a crashed
        server failing probes for its scheduled downtime.  Called by the
        :class:`~repro_torch.balancer.health.HealthMonitor` on quarantined
        servers only — never on the dispatch hot path.
        """
        return True

    def batch_call(self, thetas: Sequence[Any]) -> List[Any]:
        """Evaluate a coalesced batch; the dispatcher's single entry point.

        The legacy ``batch_fn`` contract is a Python-level loop interface:
        it receives the member thetas as a *list* and returns one result per
        member.  :class:`BatchServer` overrides this with true stacked
        dispatch.  Elements of the returned list that are ``Exception``
        instances are scattered back as per-member failures (the member's
        request errors; its batch mates are unaffected).
        """
        if self.batch_fn is None:
            raise RuntimeError(f"server '{self.name}' has no batch handler")
        results = list(self.batch_fn(list(thetas)))
        if len(results) != len(thetas):
            raise RuntimeError(
                f"batch handler of '{self.name}' returned {len(results)} "
                f"results for {len(thetas)} requests"
            )
        return results


class BatchServer(Server):
    """A server whose handler evaluates a whole stacked batch in one call.

    ``batch_fn`` takes one stacked ``(B, ...)`` parameter array and returns
    per-request results — either a ``(B, ...)`` array (row ``i`` answers
    member ``i``) or a length-``B`` sequence.  The dispatcher's coalescing
    path hands a whole same-tag batch to this server as a *single* call, so
    a ``vmap``ped (or AOT-compiled) executable runs one fused XLA launch
    instead of B sequential ones; a lone request goes through the same
    callable with B = 1, keeping batched and per-request results
    bit-identical by construction.

    ``max_batch`` caps the coalesced batch size for this server (e.g. the
    largest executable in an AOT cache); the balancer-wide ``max_batch``
    still applies on top.  ``check_finite=True`` converts members whose
    result contains ANY non-finite value into per-member
    ``FloatingPointError`` failures — one poisoned theta then fails only
    its own request, never its batch mates (vmapped math cannot raise
    per-lane, so this is the scatter-side error channel).  Leave it off
    for models whose observables may legitimately saturate to inf.
    """

    def __init__(
        self,
        batch_fn: Callable,
        *,
        name: Optional[str] = None,
        capacity_tags: Sequence[str] = (),
        max_batch: Optional[int] = None,
        check_finite: bool = False,
    ) -> None:
        super().__init__(
            self._single, name=name, capacity_tags=capacity_tags,
            batch_fn=batch_fn,
        )
        self.max_batch = max_batch
        self.check_finite = check_finite

    def _single(self, theta) -> Any:
        result = self.batch_call([theta])[0]
        if isinstance(result, BaseException):
            raise result
        return result

    def batch_call(self, thetas: Sequence[Any]) -> List[Any]:
        stacked = np.stack([np.asarray(t) for t in thetas])
        out = self.batch_fn(stacked)
        results = [np.asarray(r) for r in out]
        if len(results) != len(thetas):
            raise RuntimeError(
                f"batch handler of '{self.name}' returned {len(results)} "
                f"results for {len(thetas)} requests"
            )
        if self.check_finite:
            results = [
                r
                if np.all(np.isfinite(r))
                else FloatingPointError(
                    f"non-finite result for batch member {i} on '{self.name}'"
                )
                for i, r in enumerate(results)
            ]
        return results


class DecodeHandoff(NamedTuple):
    """Prefill -> decode handoff: what a decode slot needs to continue.

    ``state`` is the per-sequence decode state the prefill produced (an
    opaque pytree — the pool's ``insert_fn`` understands it); ``token`` is
    the first generated token (argmax of the prefill's last-position
    logits), which seeds the slot's autoregressive feed; ``max_new`` is
    the total generation budget *including* ``token``; ``eos`` stops the
    slot early when the model emits it.
    """

    state: Any
    token: int
    max_new: int
    eos: Optional[int] = None


class DecodeResult(NamedTuple):
    """What a :class:`DecodePool` request resolves to.

    ``tokens`` holds the full greedy generation (``handoff.token`` first);
    ``token_times`` has one clock stamp per token (the handoff token is
    stamped at admission), from which time-to-first-token and per-token
    latency quantiles are derived.
    """

    tokens: np.ndarray
    token_times: List[float]


@dataclass
class DecodeSlot:
    """Per-slot bookkeeping of one in-flight generation in a DecodePool."""

    req: "Request"
    slot: int
    tokens: List[int]
    times: List[float]
    max_new: int
    eos: Optional[int]

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.max_new or (
            self.eos is not None and self.tokens[-1] == self.eos
        )

    def result(self) -> DecodeResult:
        return DecodeResult(
            tokens=np.asarray(self.tokens, dtype=np.int64),
            token_times=list(self.times),
        )


class DecodePool(Server):
    """A slot-based continuous-batching decode server.

    Where :class:`BatchServer` coalesces a *window* of same-tag requests
    into one stacked call, a DecodePool owns a persistent ``(n_slots,
    ...)``-leading batched decode state and admits new requests into the
    **in-flight** batch at token boundaries: insert on a free slot, evict
    on EOS or length, so the compiled decode step always runs full-width
    instead of waiting out a coalescing window.  This is the serving-stack
    analogue of the paper's dynamic dispatch — generation lengths span
    orders of magnitude exactly like the tsunami level hierarchy, and the
    slot table is what keeps short generations from queueing behind long
    ones.

    The pool is model-agnostic; the model wiring supplies three callables
    (see :func:`repro_torch.runtime.serve_loop.make_decode_pool` for the LM
    instantiation):

    * ``step_fn(state, tokens) -> (state, next_tokens)`` — advance every
      slot one token in ONE fused call.  ``tokens`` is an ``(n_slots,)``
      int array (free slots carry a dummy feed whose output is ignored);
      ``next_tokens`` is ``(n_slots,)``.
    * ``insert_fn(state, slot, handoff_state) -> state`` — write one
      sequence's prefill-produced decode state into ``slot``.
    * ``init_state_fn() -> state`` — allocate the pooled state lazily on
      first admission.
    * ``evict_fn(state, slot) -> state`` (optional) — scrub an evicted
      slot; stale rows are dispatch-masked either way, so this is for
      hygiene, not correctness.

    Requests routed here must carry a :class:`DecodeHandoff` theta.  The
    dispatcher drives the slot lifecycle through :meth:`admit` /
    :meth:`step_once` on its continuous dispatch edge
    (``LoadBalancer._execute_continuous``); the pool itself holds only
    host-side bookkeeping and is driven by exactly one worker at a time
    (it is ``busy`` from first admission until the last slot drains).

    ``clock`` injects a fake time source for deterministic tests.
    """

    continuous = True

    def __init__(
        self,
        step_fn: Callable,
        insert_fn: Callable,
        init_state_fn: Callable,
        n_slots: int,
        *,
        name: Optional[str] = None,
        capacity_tags: Sequence[str] = (),
        evict_fn: Optional[Callable] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        super().__init__(self._no_direct_call, name=name, capacity_tags=capacity_tags)
        self.step_fn = step_fn
        self.insert_fn = insert_fn
        self.init_state_fn = init_state_fn
        self.evict_fn = evict_fn
        self.n_slots = n_slots
        self.clock = clock
        self._state: Any = None  # allocated lazily by the first admission
        self._slots: List[Optional[DecodeSlot]] = [None] * n_slots
        self._free_slots: List[int] = list(range(n_slots))
        self._next_tokens = np.zeros(n_slots, dtype=np.int64)
        # (slot, request) per admission, in admission order — the FIFO
        # fairness test's observable.
        self.admit_log: List[Tuple[int, "Request"]] = []

    def _no_direct_call(self, theta) -> Any:  # pragma: no cover
        raise RuntimeError(
            f"DecodePool '{self.name}' is driven by the dispatcher's "
            "continuous dispatch edge, not by direct fn calls"
        )

    # -- slot table reads ----------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_occupied(self) -> int:
        return self.n_slots - len(self._free_slots)

    # -- slot lifecycle (called by the dispatcher's continuous edge) ---------
    def admit(self, req: "Request", now: float) -> Optional[DecodeSlot]:
        """Insert ``req`` into the lowest free slot at a token boundary.

        Returns the slot info if the request finished *at admission* (its
        budget was a single token, already produced by prefill, or the
        handoff token is EOS) — the caller completes it without the
        request ever occupying device state.  Otherwise returns None and
        the slot joins the in-flight batch at the next :meth:`step_once`.
        """
        handoff: DecodeHandoff = req.theta
        slot = self._free_slots.pop(0)  # lowest index: deterministic layout
        info = DecodeSlot(
            req=req,
            slot=slot,
            tokens=[int(handoff.token)],
            times=[now],
            max_new=int(handoff.max_new),
            eos=None if handoff.eos is None else int(handoff.eos),
        )
        self.admit_log.append((slot, req))
        if info.finished:
            self._free_slots.append(slot)
            self._free_slots.sort()
            return info
        if self._state is None:
            self._state = self.init_state_fn()
        self._state = self.insert_fn(self._state, slot, handoff.state)
        self._slots[slot] = info
        self._next_tokens[slot] = info.tokens[-1]
        return None

    def step_once(self) -> Tuple[List[DecodeSlot], int]:
        """Advance every occupied slot one token (ONE fused call).

        Returns ``(finished slots, n_tokens_emitted)``.  Finished slots
        (EOS or length budget) are evicted — their indices free up for the
        next token-boundary join — and handed back for completion.
        """
        self._state, nxt = self.step_fn(self._state, self._next_tokens.copy())
        nxt = np.asarray(nxt)
        now = self.clock()
        finished: List[DecodeSlot] = []
        n_emitted = 0
        for slot, info in enumerate(self._slots):
            if info is None:
                continue
            tok = int(nxt[slot])
            info.tokens.append(tok)
            info.times.append(now)
            n_emitted += 1
            if info.finished:
                self._slots[slot] = None
                self._free_slots.append(slot)
                if self.evict_fn is not None:
                    self._state = self.evict_fn(self._state, slot)
                finished.append(info)
            else:
                self._next_tokens[slot] = tok
        if finished:
            self._free_slots.sort()
        return finished, n_emitted

    def occupied_slots(self) -> List[DecodeSlot]:
        """In-flight slot infos (used by the pool-death failure path)."""
        return [info for info in self._slots if info is not None]

    def clear(self) -> List[DecodeSlot]:
        """Drop every in-flight slot (pool death): bookkeeping only."""
        infos = self.occupied_slots()
        self._slots = [None] * self.n_slots
        self._free_slots = list(range(self.n_slots))
        return infos

    # -- admission hooks (refined by PagedDecodePool) ------------------------
    def admissible(self, theta: Any) -> bool:
        """Can this pool take ``theta`` *right now*?  Slab pools are
        slot-granular: a free slot (which the dispatcher already checked)
        is sufficient."""
        return True

    def block_usage(self) -> Optional[Tuple[int, int]]:
        """(used, capacity) KV blocks, or None for slab/non-paged pools."""
        return None


@dataclass
class PagedSlot(DecodeSlot):
    """A :class:`DecodeSlot` whose generation runs prefill *through the
    pool* in chunks and whose KV lives in leased block-table rows."""

    prompt: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    fed: int = 0  # prompt positions already chunked through the model
    blocks: List[int] = field(default_factory=list)  # leased pool rows

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.prompt)

    @property
    def finished(self) -> bool:
        # Until prefill completes no token has been emitted — the slot
        # cannot be finished no matter how small the budget.
        return bool(self.tokens) and (
            len(self.tokens) >= self.max_new
            or (self.eos is not None and self.tokens[-1] == self.eos)
        )


class PagedDecodePool(DecodePool):
    """A decode pool over a shared KV block pool with chunked prefill.

    Differences from the slab :class:`DecodePool`:

    * **Theta contract**: requests carry the raw ``(prompt (1, S), n_new,
      eos)`` tuple, not a :class:`DecodeHandoff` — prefill happens *inside*
      the pool, ``prefill_chunk`` positions per token boundary, interleaved
      with in-flight decode steps.  No separate prefill server monopolizes
      the device between joins.
    * **Block-granular admission**: a request joins when a slot AND enough
      free KV blocks for its maximum extent (``S + n_new - 1`` positions)
      exist.  :meth:`admissible` is the dispatcher's head-of-line gate —
      the queue head waits (FIFO preserved) rather than being skipped.
      A request that can *never* fit raises :class:`PromptTooLongError`
      at admission, failing that request without killing the pool.
    * Blocks are leased at admission and returned at eviction (EOS frees
      early) or pool death; ``block_usage()`` feeds telemetry.

    Model wiring (see ``runtime.serve_loop.make_paged_decode_pool``):

    * ``step_fn(state, tokens, active) -> (state, next_tokens)`` — one
      fused decode step; ``active`` masks slots still prefilling or free.
    * ``chunk_fn(state, slot, chunk, start_pos) -> (state, last_token)`` —
      feed ``slot`` one prompt chunk.
    * ``reset_fn(state, slot, row) -> state`` — lease block-table ``row``
      to ``slot`` and rewind its position.

    ``n_blocks`` counts *usable* blocks; the device pool carries one extra
    scratch row (row 0) that inactive slots write into, so usable rows are
    ``1..n_blocks``.  Pools for O(1)-state families (ssm) pass
    ``n_blocks=0``: every request needs zero blocks and admission is
    slot-granular, but chunked prefill still applies.
    """

    def __init__(
        self,
        step_fn: Callable,
        chunk_fn: Callable,
        reset_fn: Callable,
        init_state_fn: Callable,
        n_slots: int,
        *,
        n_blocks: int,
        block_size: int,
        max_blocks_per_slot: int,
        max_positions: int,
        prefill_chunk: int,
        name: Optional[str] = None,
        capacity_tags: Sequence[str] = (),
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        super().__init__(
            step_fn,
            insert_fn=None,
            init_state_fn=init_state_fn,
            n_slots=n_slots,
            name=name,
            capacity_tags=capacity_tags,
            clock=clock,
        )
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.chunk_fn = chunk_fn
        self.reset_fn = reset_fn
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.max_positions = int(max_positions)
        self.prefill_chunk = int(prefill_chunk)
        self.paged_kv = self.n_blocks > 0
        # Usable device rows are 1..n_blocks; row 0 is the scratch block.
        self._free_blocks: List[int] = list(range(1, self.n_blocks + 1))

    # -- admission -----------------------------------------------------------
    @staticmethod
    def _parse_theta(theta) -> Tuple[np.ndarray, int, Optional[int]]:
        prompt, n_new, eos = theta
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        return prompt, int(n_new), None if eos is None else int(eos)

    def blocks_needed(self, prompt_len: int, n_new: int) -> int:
        """Blocks for the request's maximum extent.

        Positions written = prompt (``S``) + fed-back tokens (``n_new - 1``;
        the final emitted token is never fed back).
        """
        if not self.paged_kv:
            return 0
        need = max(1, prompt_len + n_new - 1)
        return -(-need // self.block_size)  # ceil

    def _never_fits(self, prompt_len: int, n_new: int) -> bool:
        need = max(1, prompt_len + n_new - 1)
        return need > self.max_positions or self.blocks_needed(
            prompt_len, n_new
        ) > self.n_blocks

    def admissible(self, theta: Any) -> bool:
        """True when ``theta`` could join at this token boundary.

        Never-fitting requests report admissible so the dispatcher pops
        them and :meth:`admit` can fail them with the typed error —
        otherwise they would park at the queue head forever.
        """
        prompt, n_new, _ = self._parse_theta(theta)
        if self._never_fits(len(prompt), n_new):
            return True
        return len(self._free_blocks) >= self.blocks_needed(len(prompt), n_new)

    def admit(self, req: "Request", now: float) -> Optional[DecodeSlot]:
        """Lease a slot + blocks and start chunked prefill.

        Unlike the slab pool there is no instant-finish path: even a
        one-token budget needs the prompt prefillled first, so this always
        returns None (the first token is emitted by a later
        :meth:`step_once`).  Raises :class:`PromptTooLongError` for
        requests that can never fit; the caller fails the request and the
        pool lives on.
        """
        prompt, n_new, eos = self._parse_theta(req.theta)
        if len(prompt) < 1:
            raise PromptTooLongError(
                f"empty prompt submitted to paged pool '{self.name}'"
            )
        nb = self.blocks_needed(len(prompt), n_new)
        if self._never_fits(len(prompt), n_new):
            need = max(1, len(prompt) + n_new - 1)
            raise PromptTooLongError(
                f"request needs {need} cache positions ({nb} blocks) but "
                f"pool '{self.name}' caps at {self.max_positions} positions "
                f"/ {self.n_blocks} blocks"
            )
        if len(self._free_blocks) < nb or not self._free_slots:
            raise RuntimeError(
                f"admit() without capacity on '{self.name}' "
                f"(free_blocks={len(self._free_blocks)}, need={nb}, "
                f"free_slots={len(self._free_slots)})"
            )
        slot = self._free_slots.pop(0)  # lowest index: deterministic layout
        blocks = [self._free_blocks.pop(0) for _ in range(nb)]
        # Unleased table entries point at the scratch row; they are only
        # ever gathered at positions masked out by ``pos``.
        row = np.zeros(self.max_blocks_per_slot, dtype=np.int32)
        row[: len(blocks)] = blocks
        if self._state is None:
            self._state = self.init_state_fn()
        self._state = self.reset_fn(self._state, slot, row)
        info = PagedSlot(
            req=req,
            slot=slot,
            tokens=[],
            times=[],
            max_new=n_new,
            eos=eos,
            prompt=prompt,
            fed=0,
            blocks=blocks,
        )
        self._slots[slot] = info
        self.admit_log.append((slot, req))
        return None

    # -- stepping ------------------------------------------------------------
    def _evict(self, slot: int, info: PagedSlot) -> None:
        self._slots[slot] = None
        self._free_slots.append(slot)
        self._free_slots.sort()
        self._free_blocks.extend(info.blocks)
        self._free_blocks.sort()
        info.blocks = []

    def step_once(self) -> Tuple[List[DecodeSlot], int]:
        """One token boundary: a prefill chunk per prefilling slot, then
        ONE fused decode step over the decoding slots.

        A slot whose prompt completes this boundary emits its first token
        (argmax of the prefill — the TTFT stamp) and joins the fused
        decode step of this same boundary.
        """
        finished: List[DecodeSlot] = []
        n_emitted = 0
        for slot, info in enumerate(self._slots):
            if info is None or not info.prefilling:
                continue
            chunk = info.prompt[info.fed : info.fed + self.prefill_chunk]
            self._state, tok = self.chunk_fn(self._state, slot, chunk, info.fed)
            info.fed += len(chunk)
            if info.prefilling:
                continue
            info.tokens.append(int(tok))
            info.times.append(self.clock())
            n_emitted += 1
            if info.finished:
                self._evict(slot, info)
                finished.append(info)
            else:
                self._next_tokens[slot] = info.tokens[-1]

        active = np.array(
            [info is not None and not info.prefilling for info in self._slots],
            dtype=bool,
        )
        if active.any():
            self._state, nxt = self.step_fn(
                self._state, self._next_tokens.copy(), active
            )
            nxt = np.asarray(nxt)
            now = self.clock()
            for slot, info in enumerate(self._slots):
                if not active[slot] or info is None:
                    continue
                tok = int(nxt[slot])
                info.tokens.append(tok)
                info.times.append(now)
                n_emitted += 1
                if info.finished:
                    self._evict(slot, info)
                    finished.append(info)
                else:
                    self._next_tokens[slot] = tok
        return finished, n_emitted

    def clear(self) -> List[DecodeSlot]:
        """Pool death: drop slots AND return every leased block."""
        infos = super().clear()
        self._free_blocks = list(range(1, self.n_blocks + 1))
        for info in infos:
            info.blocks = []
        return infos

    def block_usage(self) -> Optional[Tuple[int, int]]:
        if not self.paged_kv:
            return None
        return (self.n_blocks - len(self._free_blocks), self.n_blocks)


@dataclass(eq=False)  # identity equality: dataclass field == would compare
class Request:        # numpy thetas ("truth value ambiguous" in queue.remove)
    """A client request, with the timestamps the paper records."""

    theta: Any
    tag: str = ""
    batchable: bool = False
    arrived_at: float = 0.0
    dispatched_at: float = 0.0
    completed_at: float = 0.0
    server: Optional[str] = None
    retries: int = 0
    result: Any = None
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event, repr=False)
    hedged: bool = False
    # global arrival sequence number, stamped by the dispatcher's indexed
    # queue at admission; orders requests across per-tag sub-queues
    seq: int = -1
    # set by streaming telemetry once this request's queue delay has been
    # folded into the running idle moments (guards double/late booking)
    idle_booked: bool = field(default=False, repr=False)
    # absolute monotonic deadline (submit_async(deadline_s=...)); a queued
    # request past it is shed with DeadlineExceeded at dispatch time
    deadline_at: Optional[float] = None

    def __post_init__(self) -> None:
        self._callbacks: List[Callable[["Request"], None]] = []
        self._cb_lock = threading.Lock()
        # Set by the dispatcher at admission; lets cancel() reach back
        # into the owning balancer without a hard reference cycle here.
        self._cancel_hook: Optional[Callable[["Request"], bool]] = None
        # Names of distinct servers whose handler died serving this
        # request — the poison-request detector's evidence set.
        self.killed_servers: set = set()

    @property
    def queue_delay(self) -> float:
        """Time between arrival and dispatch — the paper's 'idle time'."""
        return self.dispatched_at - self.arrived_at

    def cancel(self) -> bool:
        """Cancel this request if it is still *queued* (client-side
        deadline support: see :func:`repro_torch.balancer.futures.gather`).

        Returns True when the request was removed from the queue — it
        then completes immediately with :class:`RequestCancelled` set as
        its error.  Returns False when it already completed or is
        in-flight on a server (an in-flight evaluation cannot be recalled
        across a socket; callers *abandon* it instead — the result is
        discarded on completion).
        """
        hook = self._cancel_hook
        if hook is None or self.done.is_set():
            return False
        return hook(self)

    @property
    def service_time(self) -> float:
        return self.completed_at - self.dispatched_at

    # -- completion plumbing -------------------------------------------------
    def add_done_callback(self, fn: Callable[["Request"], None]) -> None:
        """Run ``fn(self)`` when the request completes (immediately if it
        already has).  Used by hedging to wait on 'first of two'."""
        with self._cb_lock:
            if not self.done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def remove_done_callback(self, fn: Callable[["Request"], None]) -> None:
        """Deregister a pending callback (no-op if absent or already fired).

        Lets repeated waiters (:func:`repro_torch.balancer.futures.wait_any`)
        clean up after themselves instead of accumulating stale closures on
        long-running requests."""
        with self._cb_lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    def _complete(self) -> None:
        """Set ``done`` and fire callbacks exactly once each."""
        with self._cb_lock:
            self.done.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


class ServerDiedError(RuntimeError):
    """A request exhausted its retries because its servers kept dying."""


class PoisonRequestError(ServerDiedError):
    """A request killed ``poison_threshold`` *distinct* servers.

    Retrying such a request further would consume the pool one server at
    a time (the classic poison-pill failure mode), so the dispatcher
    quarantines the request instead: it completes with this error and
    never re-enters the queue.  Subclasses :class:`ServerDiedError` so
    callers handling generic server-death failures keep working.
    """


class PromptTooLongError(ValueError):
    """A generation request can never fit its serving pool: the prompt plus
    generation budget exceeds ``cache_len`` (slab) or the pool's total KV
    blocks (paged).  Raised at admission/submission as a typed per-request
    failure — the alternative is silent cache wraparound corrupting the
    oldest positions, which is never what the client meant."""


class RequestCancelled(RuntimeError):
    """A queued request was cancelled by its client (deadline/cancel)."""


class QueueFull(RuntimeError):
    """Admission control rejected a submission: the tag's queue is at its
    configured ``max_queue_per_tag`` depth.  The request is never queued
    and never booked in telemetry history (only the shed counter moves);
    clients back off or shed load themselves."""


class DeadlineExceeded(RuntimeError):
    """A queued request crossed its ``deadline_s`` before any server was
    free to take it: shed at dispatch time instead of evaluating work
    whose client has already given up."""
