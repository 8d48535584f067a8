"""The port's span recorder: where the time of a request, a pool call or an
ensemble round went, as spans on the balancer's clock (``time.monotonic``).

:data:`SPANS` is the process's one recorder.  It is off unless a reader
enables it: a span site then costs one test of ``SPANS.on`` (no clock read,
no object, no lock).  It lives in a module of its own, which imports
nothing of the port, because the sites that record are in several layers
(the balancer, the level pools, the ensemble drivers) and the pools do not
hold a balancer.

The spans, by layer (``n`` is one small integer a span carries):

* ``balancer.request`` (arrival to completion; ``n`` the batch size), with
  children ``balancer.queue`` (arrival to pop; ``balancer.admit``, submit
  to admission, on a continuous pool), ``balancer.coalesce`` (pop to the
  dispatch stamp, when a coalescing window held the request) and
  ``balancer.service`` (dispatch to completion; ``tag`` the server).
  Booked by ``balancer.telemetry`` from the stamps a ``Request`` carries.
* ``pool.prefill``, per request of a paged pool: admission to its first
  token (``n`` the prompt's chunks).
* ``pool.call`` (a level pool's handler; ``n`` the rows), with child
  ``pool.sync``, its read of the result to the host.
* ``driver.round`` (one ensemble run; ``n`` the fine samples), with
  children ``driver.wait`` (waiting on the balancer) and ``driver.sync``
  (reading the ensemble's graphs' results).
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Dict, List, NamedTuple

# Records the recorder holds before it drops (and counts) the rest.
SPAN_CAPACITY = 1 << 20


class Span(NamedTuple):
    """One record of the :class:`SpanRecorder`, on ``time.monotonic``."""

    id: int  # the span's own id, 0 where no span names it as parent
    name: str
    start: float
    end: float
    thread: int  # the thread's native id (threading.get_native_id())
    parent: int  # id of the enclosing span, 0 for none
    request: int  # Request.seq, -1 for none
    tag: str
    n: int  # one small integer: rows, chunks or batch size


class SpanLog(NamedTuple):
    """What :meth:`SpanRecorder.drain` returns."""

    spans: List[Span]
    dropped: int  # records refused since the last drain (the ring was full)
    threads: Dict[int, str]  # native id -> name, of the threads alive at the drain
    # threading.get_ident() -> native id, of the same threads: a profiler
    # names threads other than its own by the former
    idents: Dict[int, int]


class SpanRecorder:
    """Spans in a bounded ring.

    While on, a record is one tuple appended to a deque without a lock, as
    ``balancer.telemetry.Telemetry`` records.  The ring holds ``capacity``
    records (a few more when threads race at the edge); past that each
    record is refused and counted, and a reader that finds ``dropped``
    above 0 has a truncated window.  No span synchronises the card: a span
    that waits on it wraps a host read that the code makes anyway.
    """

    def __init__(self, capacity: int = SPAN_CAPACITY) -> None:
        self.on = False
        self.capacity = int(capacity)
        self._ring: deque = deque()
        self._ids = itertools.count(1)
        self._dropped = 0
        self._drop_lock = threading.Lock()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def new_id(self) -> int:
        """An id for a span that others will name as parent (taken when it
        opens: it is recorded when it closes, after its children)."""
        return next(self._ids)

    def add(self, name: str, start: float, end: float, *, id: int = 0, parent: int = 0,
            request: int = -1, tag: str = "", n: int = 0) -> None:
        if len(self._ring) < self.capacity:
            # get_ident() makes no system call; drain() puts the native id
            # in its place.
            self._ring.append((id, name, start, end, threading.get_ident(), parent,
                               request, tag, n))
        else:
            with self._drop_lock:  # the slow path only: counted exactly
                self._dropped += 1

    def drain(self) -> SpanLog:
        """Take every record so far (in the order recorded) and the count
        of those refused.  Records added while it runs go to the next
        drain; none is lost.  A record's thread is its native id where the
        thread is still alive (a thread that has ended keeps its
        ``threading.get_ident()``)."""
        alive = [t for t in threading.enumerate() if t.native_id]
        native = {t.ident: t.native_id for t in alive}
        ring = self._ring
        spans = []
        for _ in range(len(ring)):
            r = ring.popleft()
            spans.append(Span(r[0], r[1], r[2], r[3], native.get(r[4], r[4]), *r[5:]))
        with self._drop_lock:
            dropped, self._dropped = self._dropped, 0
        return SpanLog(spans, dropped, {t.native_id: t.name for t in alive}, native)


SPANS = SpanRecorder()
