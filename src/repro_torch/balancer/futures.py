"""Client-side future primitives over :class:`~repro_torch.balancer.types.Request`.

The dispatcher already completes requests through ``Request._complete`` and
exposes ``add_done_callback``; this module builds the *multi-request*
waiting primitives on top of that, so a single client thread can keep many
requests outstanding and react to whichever finishes first — the usage
pattern of the ensemble driver (``repro_torch.ensemble``) and of any client that
wants to overlap coarse and fine forward solves.

Both primitives treat errored requests (server death after retries,
balancer shutdown) as *completed*: they are returned/yielded with
``req.error`` set rather than hidden, so a driver multiplexing many chains
can surface the failure for exactly the chain that hit it.  See DESIGN.md §8.
"""
from __future__ import annotations

import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence

from .types import Request


def wait_any(requests: Iterable[Request], timeout: Optional[float] = None) -> List[Request]:
    """Block until at least one of ``requests`` has completed.

    Returns the completed subset (in input order; completion includes
    errored requests — check ``req.error``).  Raises :class:`TimeoutError`
    if ``timeout`` seconds elapse with nothing completed.  An empty input
    returns an empty list immediately.
    """
    reqs = list(requests)
    if not reqs:
        return []
    done = [r for r in reqs if r.done.is_set()]
    if done:
        return done
    first = threading.Event()
    notify = lambda _r: first.set()  # one shared closure: removable by identity
    for r in reqs:
        r.add_done_callback(notify)
    try:
        if not first.wait(timeout):
            raise TimeoutError(
                f"none of {len(reqs)} requests completed within {timeout}s"
            )
    finally:
        # Deregister so repeated waits over an overlapping request set
        # (as_completed, a multiplexing driver loop) stay O(1) callbacks
        # per request instead of accumulating one closure per wait round.
        for r in reqs:
            r.remove_done_callback(notify)
    return [r for r in reqs if r.done.is_set()]


def as_completed(
    requests: Iterable[Request], timeout: Optional[float] = None
) -> Iterator[Request]:
    """Yield requests as they complete (errored ones included).

    The iterator finishes once every input request has been yielded exactly
    once.  ``timeout`` bounds the *total* wait: if it elapses with requests
    still pending, :class:`TimeoutError` is raised (like
    ``concurrent.futures.as_completed``).
    """
    pending: List[Request] = list(requests)
    deadline = None if timeout is None else time.monotonic() + timeout
    while pending:
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"{len(pending)} requests still pending")
        done = wait_any(pending, remaining)
        done_ids = {id(r) for r in done}
        pending = [r for r in pending if id(r) not in done_ids]
        for r in done:
            yield r


def gather(
    requests: Sequence[Request],
    timeout: Optional[float] = None,
    *,
    cancel_pending: bool = False,
) -> List[Request]:
    """Wait for *all* requests; returns them in input order.

    Convenience over :func:`as_completed` for barrier-style clients
    (``submit_many`` + ``gather`` is the batch round trip).

    ``timeout`` bounds the total wait; on expiry :class:`TimeoutError` is
    raised.  With ``cancel_pending`` the deadline also *reclaims* what it
    can before raising: every request still sitting in the arrival queue
    is cancelled (it completes with
    :class:`~repro_torch.balancer.types.RequestCancelled` set as its error) so
    the balancer never evaluates work whose client has given up.
    Requests already in flight on a server cannot be recalled across a
    socket — they are abandoned, finishing in the background with their
    results discarded.
    """
    try:
        for _ in as_completed(requests, timeout):
            pass
    except TimeoutError:
        if cancel_pending:
            for r in requests:
                if not r.done.is_set():
                    r.cancel()
        raise
    return list(requests)
