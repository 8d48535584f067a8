"""Indexed dispatch structures: per-tag FIFO sub-queues + free-server index.

The seed dispatcher kept one flat arrival ``deque`` and re-derived
everything per decision: an O(queue x servers) policy scan to find the
earliest dispatchable request, an O(queue) ``deque.remove``, an O(servers)
servability check per submit.  At ensemble scale with sub-millisecond GP
requests those scans *are* the idle time.

This module replaces the derivations with incrementally-maintained
indexes, so one dispatch decision is O(distinct queued tags + free
candidates for the chosen tag) — independent of queue length and, on the
admission/wakeup paths, of pool size:

* :class:`IndexedQueue` — one FIFO sub-queue per tag, ordered globally by
  an arrival sequence number stamped at push.  The earliest dispatchable
  request overall is the earliest *head* among tags with a free candidate
  (within a tag, arrival order is queue order), so the paper's FIFO
  fairness and head-of-line-blocking avoidance fall out of the index
  instead of a scan.  Popping the selected head is O(1).
* :class:`FreeServerIndex` — per-tag dict of free live servers (wildcard
  servers tracked separately) plus live-server counts per tag, maintained
  on busy/free/death/retire/add transitions.  Gives O(1) ``servable`` for
  submit-time admission, O(1) ``has_free_for`` for targeted dispatcher
  wakeups, and the ready candidate list for
  :meth:`~repro_torch.balancer.policies.SchedulingPolicy.select_ready`.

Both structures are owned by the dispatcher and mutated only under its
mutex; they carry no locks of their own.  See DESIGN.md §2.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .types import Request, Server


class IndexedQueue:
    """Per-tag FIFO sub-queues keyed by a global arrival sequence number.

    Iteration order (used by checkpointing and the legacy flat-scan policy
    path) is global arrival order — a lazy O(n log tags) heap-merge of the
    per-tag sub-queues, deliberately off the dispatch hot path.
    """

    def __init__(self) -> None:
        self._seq = itertools.count()
        self._front = -1  # decreasing seq series for push_front re-entries
        self._by_tag: Dict[str, deque] = {}
        self._n = 0
        self._n_batchable: Dict[str, int] = {}

    # -- hot-path mutation ---------------------------------------------------
    def push(self, req: Request) -> None:
        """Append ``req`` to its tag's sub-queue with a fresh arrival seq."""
        req.seq = next(self._seq)
        dq = self._by_tag.get(req.tag)
        if dq is None:
            dq = self._by_tag[req.tag] = deque()
        dq.append(req)
        self._n += 1
        if req.batchable:
            self._n_batchable[req.tag] = self._n_batchable.get(req.tag, 0) + 1

    def push_front(self, req: Request) -> None:
        """Reinsert ``req`` at the *global* front of the queue (used when a
        whole coalesced batch fails and its members retry in place).

        Mirrors the flat deque's ``appendleft``: the request receives a
        seq below every other queued request, so it dispatches before
        them — and each per-tag sub-queue stays sorted by seq, which the
        heads()/__iter__ ordering relies on.
        """
        req.seq = self._front
        self._front -= 1
        dq = self._by_tag.get(req.tag)
        if dq is None:
            dq = self._by_tag[req.tag] = deque()
        dq.appendleft(req)
        self._n += 1
        if req.batchable:
            self._n_batchable[req.tag] = self._n_batchable.get(req.tag, 0) + 1

    def pop(self, req: Request) -> None:
        """Remove ``req`` — O(1) when it is its tag's head (the dispatch
        case); a tag-local scan otherwise (legacy flat-scan policies)."""
        dq = self._by_tag[req.tag]
        if dq[0] is req:
            dq.popleft()
        else:
            dq.remove(req)
        self._forget(req)

    def _forget(self, req: Request) -> None:
        self._n -= 1
        if req.batchable:
            left = self._n_batchable.get(req.tag, 0) - 1
            if left > 0:
                self._n_batchable[req.tag] = left
            else:
                self._n_batchable.pop(req.tag, None)
        if not self._by_tag.get(req.tag):
            self._by_tag.pop(req.tag, None)

    def drain_batchable(self, tag: str, limit: int) -> List[Request]:
        """Pop up to ``limit`` batchable requests of ``tag`` in arrival
        order, leaving non-batchable same-tag requests (and every other
        tag) in place with relative order untouched."""
        dq = self._by_tag.get(tag)
        if not dq or limit <= 0:
            return []
        taken: List[Request] = []
        kept: List[Request] = []
        while dq and len(taken) < limit:
            r = dq.popleft()
            if r.batchable:
                taken.append(r)
            else:
                kept.append(r)
        for r in reversed(kept):
            dq.appendleft(r)
        for r in taken:
            self._forget(r)
        return taken

    def drain_tag_limit(self, tag: str, limit: int) -> List[Request]:
        """Pop up to ``limit`` requests of ``tag`` in arrival order,
        batchable or not (the continuous-batching token-boundary join:
        every queued request of a decode tag is a slot candidate)."""
        dq = self._by_tag.get(tag)
        if not dq or limit <= 0:
            return []
        taken: List[Request] = []
        while dq and len(taken) < limit:
            taken.append(dq.popleft())
        for r in taken:
            self._forget(r)
        return taken

    def drain_all(self) -> List[Request]:
        """Remove and return every queued request in arrival order."""
        out = list(self)
        self._by_tag.clear()
        self._n_batchable.clear()
        self._n = 0
        return out

    def drain_tag(self, tag: str) -> List[Request]:
        """Remove and return every request of ``tag`` in arrival order."""
        dq = self._by_tag.pop(tag, None)
        if not dq:
            return []
        self._n -= len(dq)
        self._n_batchable.pop(tag, None)
        return list(dq)

    # -- hot-path reads ------------------------------------------------------
    def heads(self) -> Iterator[Tuple[str, Request]]:
        """Yield ``(tag, head request)`` per non-empty sub-queue."""
        for tag, dq in self._by_tag.items():
            yield tag, dq[0]

    def tags(self) -> List[str]:
        return list(self._by_tag)

    def count_batchable(self, tag: str) -> int:
        return self._n_batchable.get(tag, 0)

    def count_tag(self, tag: str) -> int:
        """Queued requests of ``tag`` — the admission-control depth check."""
        return len(self._by_tag.get(tag, ()))

    def head(self, tag: str) -> Optional[Request]:
        """Peek the head request of ``tag`` (None when empty) — used by
        deadline shedding to pop expired heads without a drain."""
        dq = self._by_tag.get(tag)
        return dq[0] if dq else None

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __contains__(self, req: Request) -> bool:
        return req in self._by_tag.get(req.tag, ())

    def __iter__(self) -> Iterator[Request]:
        """Global arrival order across all tags (off the hot path)."""
        return iter(
            heapq.merge(
                *(list(dq) for dq in self._by_tag.values()),
                key=lambda r: r.seq,
            )
        )


class FreeServerIndex:
    """Free/live server bookkeeping, maintained per transition.

    ``candidates(tag)`` returns the free live servers accepting ``tag`` in
    pool order — the same order the seed's flat ``[s for s in servers]``
    scan produced, so ``fifo``'s stable least-recently-freed min (and every
    other policy's tie-break) sees an identical candidate sequence and the
    recorded seed dispatch trace stays byte-identical.
    """

    def __init__(self, servers: Sequence[Server] = ()) -> None:
        self._pool_pos: Dict[int, int] = {}  # id(server) -> registration order
        self._next_pos = 0  # monotonic: re-admissions get a fresh position
        self._free_tagged: Dict[str, Dict[int, Server]] = {}
        self._free_wild: Dict[int, Server] = {}
        self._live_tagged: Dict[str, int] = {}
        self._n_live_wild = 0
        for s in servers:
            self.add(s)

    # -- membership / lifecycle ----------------------------------------------
    def add(self, server: Server) -> None:
        """Register ``server`` (initial pool, elastic add, or health-monitor
        re-admission after :meth:`mark_dead`).  Positions come from a
        monotonic counter, NOT ``len(_pool_pos)``: a re-admitted server's
        old position was tombstoned to None at death, so a length-based
        position would collide with a live server's (or stay None) and
        corrupt the pool-order sort in :meth:`candidates`.  Re-admission
        therefore appends to pool order — with no deaths the positions
        are the familiar 0, 1, 2, ... and the seed trace is unchanged.
        """
        key = id(server)
        if self._pool_pos.get(key) is None:  # new, or re-admitted after death
            self._pool_pos[key] = self._next_pos
            self._next_pos += 1
        if server.dead:
            return
        if server.capacity_tags:
            for tag in server.capacity_tags:
                self._live_tagged[tag] = self._live_tagged.get(tag, 0) + 1
        else:
            self._n_live_wild += 1
        if not server.busy:
            self._insert_free(server)

    def mark_dead(self, server: Server) -> None:
        """A death or retirement: drop from the free index + live counts.

        Idempotent — retire-then-die (or double retire by name) must not
        underflow the live counts.
        """
        key = id(server)
        if key in self._pool_pos and self._pool_pos[key] is not None:
            self._remove_free(server)
            if server.capacity_tags:
                for tag in server.capacity_tags:
                    left = self._live_tagged.get(tag, 0) - 1
                    if left > 0:
                        self._live_tagged[tag] = left
                    else:
                        self._live_tagged.pop(tag, None)
            else:
                self._n_live_wild -= 1
            self._pool_pos[key] = None  # registered but no longer live

    def mark_busy(self, server: Server) -> None:
        self._remove_free(server)

    def mark_free(self, server: Server) -> None:
        if not server.dead:
            self._insert_free(server)

    def _insert_free(self, server: Server) -> None:
        key = id(server)
        if server.capacity_tags:
            for tag in server.capacity_tags:
                self._free_tagged.setdefault(tag, {})[key] = server
        else:
            self._free_wild[key] = server

    def _remove_free(self, server: Server) -> None:
        key = id(server)
        if server.capacity_tags:
            for tag in server.capacity_tags:
                bucket = self._free_tagged.get(tag)
                if bucket is not None:
                    bucket.pop(key, None)
                    if not bucket:
                        self._free_tagged.pop(tag, None)
        else:
            self._free_wild.pop(key, None)

    # -- O(1) reads ----------------------------------------------------------
    def servable(self, tag: str) -> bool:
        """Does any *live* server accept ``tag``?  (Admission check.)"""
        return self._n_live_wild > 0 or self._live_tagged.get(tag, 0) > 0

    def has_free_for(self, tag: str) -> bool:
        """Does any *free* live server accept ``tag``?  (Targeted wakeup.)"""
        return bool(self._free_wild) or tag in self._free_tagged

    def candidates(self, tag: str) -> List[Server]:
        """Free live servers accepting ``tag``, in pool order."""
        tagged = self._free_tagged.get(tag)
        if tagged:
            out = list(tagged.values())
            if self._free_wild:
                out.extend(self._free_wild.values())
        elif self._free_wild:
            out = list(self._free_wild.values())
        else:
            return []
        pos = self._pool_pos
        out.sort(key=lambda s: pos[id(s)])
        return out
