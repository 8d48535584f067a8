"""Client transports + remote server types (the balancer's network edge).

Two wire modes against the same :class:`repro_torch.net.server.ServerShell`:

* :class:`BinaryTransport` — the fast path: persistent pooled
  connections, **pipelined** (any number of in-flight frames per
  connection; a reader thread matches responses to waiters by id), raw
  little-endian array payloads (zero-copy via ``memoryview`` /
  ``np.frombuffer``).  A coalesced ``(B, ...)`` batch crosses the wire
  as ONE ``eval_batch`` frame.
* :class:`JSONTransport` — the UM-Bridge-compatible interop mode:
  HTTP/1.1 keep-alive ``POST /Evaluate`` with JSON number payloads, one
  in-flight request per pooled connection (HTTP has no id channel).
  Batches still ship as one request (``input`` = B parameter vectors).

Both retry transient transport faults (connect refused/reset, read
timeout) with exponential backoff on a fresh connection — forward solves
are pure, so replays are safe — and raise :class:`TransportError` once
``retries`` are exhausted.  :class:`RemoteServer` /
:class:`RemoteBatchServer` let that error propagate out of the handler,
which is exactly the in-process dispatcher's server-death edge: the
remote server is marked dead, in-flight members requeue onto surviving
replicas, and ``max_retries`` bounds the total attempts (DESIGN.md §11).

Per-member failures never take that path: they cross in the response
header's ``errors`` map and come back as ``Exception`` *result* entries,
which the dispatcher scatters to the owning requests — identical
semantics to a local :class:`~repro_torch.balancer.types.BatchServer`.
"""
from __future__ import annotations

import itertools
import json
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.balancer.types import BatchServer, Server

from .framing import MAGIC, decode_error, recv_frame, send_frame


class TransportError(ConnectionError):
    """A remote call failed at the transport layer after every retry.

    Raised out of ``RemoteServer.fn`` / ``RemoteBatchServer.batch_call``
    so the dispatcher's existing server-death path handles it: the remote
    server dies, its requests requeue elsewhere.
    """


def parse_address(address: "str | Tuple[str, int]") -> Tuple[str, int]:
    if isinstance(address, tuple):
        return address[0], int(address[1])
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)


def tcp_dialer(
    address: "str | Tuple[str, int]", connect_timeout: float = 5.0
) -> Callable[[], socket.socket]:
    """A dial callable for :class:`BinaryTransport`/:class:`JSONTransport`
    targeting a TCP endpoint (``"host:port"`` or ``(host, port)``)."""
    host, port = parse_address(address)

    def dial() -> socket.socket:
        s = socket.create_connection((host, port), timeout=connect_timeout)
        s.settimeout(None)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP families (socketpair fallback) have no NODELAY
        return s

    return dial


class _Waiter:
    __slots__ = ("event", "header", "arrays")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.header: Optional[Dict[str, Any]] = None
        self.arrays: List[np.ndarray] = []


class _BinConn:
    """One pipelined binary connection: write lock + reader thread."""

    def __init__(self, sock: socket.socket, name: str) -> None:
        self.sock = sock
        self.dead = False
        self.write_lock = threading.Lock()
        self.waiters: Dict[int, _Waiter] = {}
        self.waiters_lock = threading.Lock()
        self.ids = itertools.count()
        sock.sendall(MAGIC)  # negotiate binary mode for this connection
        self.reader = threading.Thread(
            target=self._read_loop, name=name, daemon=True
        )
        self.reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                header, arrays = recv_frame(self.sock)
                if header is None:
                    break
                with self.waiters_lock:
                    w = self.waiters.pop(header.get("id"), None)
                if w is not None:
                    w.header, w.arrays = header, arrays
                    w.event.set()
        except (OSError, ConnectionError, ValueError, json.JSONDecodeError):
            pass
        self._fail_pending()

    def _fail_pending(self) -> None:
        self.dead = True
        with self.waiters_lock:
            pending, self.waiters = list(self.waiters.values()), {}
        for w in pending:  # header stays None: roundtrip() raises
            w.event.set()

    def roundtrip(
        self,
        header: Dict[str, Any],
        arrays: Sequence[Any],
        timeout: Optional[float],
    ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        rid = next(self.ids)
        header = dict(header)
        header["id"] = rid
        w = _Waiter()
        with self.waiters_lock:
            if self.dead:
                raise TransportError("connection lost")
            self.waiters[rid] = w
        try:
            with self.write_lock:
                send_frame(self.sock, header, arrays)
        except OSError as exc:
            self.close()
            raise TransportError(f"send failed: {exc}") from exc
        if not w.event.wait(timeout):
            # Frames on this connection can no longer be matched reliably
            # (the stale response would alias a future id): kill it and
            # let the retry layer redial.
            self.close()
            raise TransportError(f"read timed out after {timeout}s")
        if w.header is None:
            raise TransportError("connection lost mid-request")
        return w.header, w.arrays

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._fail_pending()

    def join(self) -> None:
        if self.reader is not threading.current_thread():
            self.reader.join()


class _Transport:
    """Shared connection-pool + retry/backoff machinery."""

    def __init__(
        self,
        dial: Callable[[], socket.socket],
        *,
        n_connections: int = 2,
        read_timeout: float = 30.0,
        retries: int = 2,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        backoff_jitter: float = 0.5,
        name: str = "transport",
    ) -> None:
        self.dial = dial
        self.n_connections = max(1, n_connections)
        self.read_timeout = read_timeout
        self.retries = max(0, retries)
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter = min(1.0, max(0.0, backoff_jitter))
        self._jitter_rng = np.random.default_rng()
        self.name = name
        self._conns: List[Optional[Any]] = [None] * self.n_connections
        self._old: List[Any] = []  # dead conns kept so close() can join them
        self._cursor = itertools.count()
        self._lock = threading.Lock()
        self._closed = False

    # subclasses: build one live connection object / run one round trip
    def _connect(self, slot: int):  # pragma: no cover - abstract
        raise NotImplementedError

    def _is_dead(self, conn) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def _close_conn(self, conn) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _pick(self):
        """Round-robin over the pool, (re)dialing dead slots lazily."""
        slot = next(self._cursor) % self.n_connections
        with self._lock:
            if self._closed:
                raise TransportError(f"transport '{self.name}' closed")
            conn = self._conns[slot]
            if conn is not None and not self._is_dead(conn):
                return conn
            if conn is not None:
                self._old.append(conn)
            try:
                conn = self._connect(slot)
            except OSError as exc:
                raise TransportError(f"dial failed: {exc}") from exc
            self._conns[slot] = conn
            return conn

    def _with_retry(self, fn: Callable[[Any], Any], timeout: Optional[float]):
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                # Exponential backoff, capped (a high-retry transport must
                # not sleep unboundedly long) and jittered *downward* by up
                # to ``backoff_jitter`` of the delay: when a server restart
                # kills every client's connections at once, full-strength
                # synchronized backoff makes them all redial on the same
                # beat (a reconnect stampede) — randomizing within
                # [(1 - jitter) * delay, delay] decorrelates the herd while
                # never waiting longer than the deterministic schedule.
                delay = min(
                    self.backoff_cap_s, self.backoff_s * (2 ** (attempt - 1))
                )
                time.sleep(
                    delay
                    * (1.0 - self.backoff_jitter * self._jitter_rng.random())
                )
            try:
                return fn(self._pick())
            except TransportError as exc:
                last = exc
        raise TransportError(
            f"remote call failed after {self.retries + 1} attempts: {last}"
        )

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for c in self._conns if c is not None] + self._old
            self._conns = [None] * self.n_connections
            self._old = []
        for c in conns:
            self._close_conn(c)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the wire API used by RemoteServer / RemoteBatchServer --------------
    def info(self) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def probe(self, timeout: float = 1.0) -> bool:  # pragma: no cover
        raise NotImplementedError

    def eval_single(
        self, tag: str, theta: Any, timeout: Optional[float] = None
    ) -> Tuple[Any, float]:  # pragma: no cover - abstract
        raise NotImplementedError

    def eval_batch(
        self, tag: str, stacked: np.ndarray, timeout: Optional[float] = None
    ) -> Tuple[List[Any], float]:  # pragma: no cover - abstract
        raise NotImplementedError


class BinaryTransport(_Transport):
    """Pipelined binary-framing client (see module docstring)."""

    def _connect(self, slot: int) -> _BinConn:
        return _BinConn(self.dial(), name=f"{self.name}-reader-{slot}")

    def _is_dead(self, conn: _BinConn) -> bool:
        return conn.dead

    def _close_conn(self, conn: _BinConn) -> None:
        conn.close()
        conn.join()

    def _call(
        self,
        op: str,
        tag: str,
        arrays: Sequence[Any],
        timeout: Optional[float],
    ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        timeout = self.read_timeout if timeout is None else timeout

        def run(conn: _BinConn):
            header, payload = conn.roundtrip({"op": op, "tag": tag}, arrays, timeout)
            if header.get("op") == "error":
                # Whole-call server-side fault: NOT a transport error (the
                # wire worked) — surface it as the handler exception it is.
                raise decode_error(header["error"])
            return header, payload

        return self._with_retry(run, timeout)

    def info(self) -> Dict[str, Any]:
        header, _ = self._call("info", "", (), None)
        return header

    def probe(self, timeout: float = 1.0) -> bool:
        """One heartbeat frame, SINGLE attempt — no retry, no backoff
        sleep: the health monitor that calls this schedules its own probe
        cadence, and a probe that has to redial a dead server should fail
        fast, not camp a monitor tick on the retry ladder.  Any complete
        round trip counts as alive (the shell is serving frames)."""
        try:
            conn = self._pick()
            header, _ = conn.roundtrip({"op": "probe", "tag": ""}, (), timeout)
            return header is not None
        except (TransportError, OSError):
            return False

    def eval_single(
        self, tag: str, theta: Any, timeout: Optional[float] = None
    ) -> Tuple[Any, float]:
        header, payload = self._call("eval", tag, [np.asarray(theta)], timeout)
        service_s = float(header.get("service_s", 0.0))
        errors = header.get("errors")
        if errors:
            return decode_error(errors["0"]), service_s
        return payload[0], service_s

    def eval_batch(
        self, tag: str, stacked: np.ndarray, timeout: Optional[float] = None
    ) -> Tuple[List[Any], float]:
        header, payload = self._call("eval_batch", tag, [stacked], timeout)
        service_s = float(header.get("service_s", 0.0))
        errors = {int(k): v for k, v in (header.get("errors") or {}).items()}
        rows = payload[0]
        return [
            decode_error(errors[i]) if i in errors else rows[i]
            for i in range(len(stacked))
        ], service_s


class _HTTPConn:
    """One keep-alive HTTP connection; exclusive (no HTTP pipelining)."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.dead = False
        self.lock = threading.Lock()
        self._buf = b""

    def roundtrip(
        self,
        method: str,
        path: str,
        body: Optional[bytes],
        timeout: Optional[float],
    ) -> Tuple[str, bytes]:
        payload = body or b""
        head = (
            f"{method} {path} HTTP/1.1\r\n"
            "Host: shell\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n"
        ).encode("latin-1")
        with self.lock:
            try:
                self.sock.settimeout(timeout)
                self.sock.sendall(head + payload)
                return self._read_response()
            except (OSError, ConnectionError) as exc:
                self.dead = True
                raise TransportError(f"http round trip failed: {exc}") from exc

    def _read_response(self) -> Tuple[str, bytes]:
        while b"\r\n\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self._buf += chunk
        head, self._buf = self._buf.split(b"\r\n\r\n", 1)
        lines = head.decode("latin-1").split("\r\n")
        status = lines[0].split(" ", 1)[1]
        clen = 0
        for ln in lines[1:]:
            if ln.lower().startswith("content-length:"):
                clen = int(ln.split(":", 1)[1])
        while len(self._buf) < clen:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed mid-body")
            self._buf += chunk
        body, self._buf = self._buf[:clen], self._buf[clen:]
        return status, body

    def close(self) -> None:
        self.dead = True
        try:
            self.sock.close()
        except OSError:
            pass


class JSONTransport(_Transport):
    """UM-Bridge-compatible HTTP/JSON client (the interop mode).

    Number payloads are JSON lists (float64 on return) — the protocol for
    foreign UM-Bridge servers and clients, not the perf path;
    ``benchmarks/bench_remote.py`` quantifies the gap vs binary framing.
    """

    def _connect(self, slot: int) -> _HTTPConn:
        return _HTTPConn(self.dial())

    def _is_dead(self, conn: _HTTPConn) -> bool:
        return conn.dead

    def _close_conn(self, conn: _HTTPConn) -> None:
        conn.close()

    def _request(
        self,
        method: str,
        path: str,
        obj: Optional[Dict[str, Any]],
        timeout: Optional[float],
    ) -> Dict[str, Any]:
        timeout = self.read_timeout if timeout is None else timeout
        body = None if obj is None else json.dumps(obj).encode()

        def run(conn: _HTTPConn) -> Dict[str, Any]:
            status, reply = conn.roundtrip(method, path, body, timeout)
            out = json.loads(reply or b"{}")
            if not status.startswith("200"):
                err = out.get("error", {})
                raise decode_error(
                    [err.get("type", "RuntimeError"), err.get("message", status)]
                )
            return out

        return self._with_retry(run, timeout)

    def info(self) -> Dict[str, Any]:
        out = self._request("GET", "/Info", None, None)
        out["tags"] = out.get("models", [])
        return out

    def probe(self, timeout: float = 1.0) -> bool:
        """One ``GET /Info`` heartbeat, single attempt (see
        :meth:`BinaryTransport.probe` for the no-retry rationale)."""
        try:
            conn = self._pick()
            status, _ = conn.roundtrip("GET", "/Info", None, timeout)
            return status.startswith("200")
        except (TransportError, OSError):
            return False

    def eval_single(
        self, tag: str, theta: Any, timeout: Optional[float] = None
    ) -> Tuple[Any, float]:
        rows, service_s = self.eval_batch(
            tag, np.asarray(theta)[None], timeout=timeout
        )
        return rows[0], service_s

    def eval_batch(
        self, tag: str, stacked: np.ndarray, timeout: Optional[float] = None
    ) -> Tuple[List[Any], float]:
        obj = {
            "name": tag,
            "input": [np.atleast_1d(row).tolist() for row in np.asarray(stacked)],
            "config": {},
        }
        out = self._request("POST", "/Evaluate", obj, timeout)
        errors = {int(k): v for k, v in (out.get("memberErrors") or {}).items()}
        rows: List[Any] = []
        for i, row in enumerate(out["output"]):
            if i in errors:
                rows.append(decode_error(errors[i]))
            else:
                arr = np.asarray(row)
                rows.append(arr[0] if arr.shape == (1,) else arr)
        return rows, float(out.get("time", 0.0))


TransportTarget = Union[str, Tuple[str, int], Callable[[], socket.socket], Any]


def make_transport(
    target: TransportTarget,
    *,
    binary: bool = True,
    connect_timeout: float = 5.0,
    **kwargs: Any,
) -> _Transport:
    """Build a transport for ``target``: a ``"host:port"`` string /
    ``(host, port)`` tuple (TCP), a :class:`~repro_torch.net.server.ServerShell`
    (its own :meth:`~repro_torch.net.server.ServerShell.dial` — socketpair when
    loopback-only), or any 0-arg dial callable returning a socket."""
    if isinstance(target, (str, tuple)):
        dial = tcp_dialer(target, connect_timeout=connect_timeout)
    elif hasattr(target, "dial"):  # a ServerShell (socketpair when loopback)
        dial = target.dial
    elif callable(target):
        dial = target
    else:
        raise TypeError(f"cannot dial {target!r}")
    cls = BinaryTransport if binary else JSONTransport
    return cls(dial, **kwargs)


class RemoteServer(Server):
    """A :class:`~repro_torch.balancer.types.Server` whose handler lives across
    a socket: one ``eval`` per request through ``transport``.

    The dispatcher sees an ordinary server; ``remote = True`` additionally
    makes it split each completion into wire time vs remote service time
    (``last_service_s``, reported by the shell) in telemetry.
    """

    remote = True

    def __init__(
        self,
        transport: _Transport,
        tag: str,
        *,
        name: Optional[str] = None,
        request_timeout: Optional[float] = None,
    ) -> None:
        super().__init__(self._call, name=name, capacity_tags=(tag,))
        self.transport = transport
        self.tag = tag
        self.request_timeout = request_timeout

    def _call(self, theta: Any) -> Any:
        result, service_s = self.transport.eval_single(
            self.tag, theta, timeout=self.request_timeout
        )
        self.last_service_s = service_s
        return result  # Exception instances = per-member failures

    def probe(self) -> bool:
        """Heartbeat across the transport — the health monitor's remote
        liveness check (in-process servers inherit the no-op True)."""
        return self.transport.probe()


class RemoteBatchServer(BatchServer):
    """A :class:`~repro_torch.balancer.types.BatchServer` across a socket: the
    dispatcher's coalesced ``(B, ...)`` batch ships as ONE framed
    ``eval_batch`` call, per-member error scatter preserved end to end."""

    remote = True

    def __init__(
        self,
        transport: _Transport,
        tag: str,
        *,
        name: Optional[str] = None,
        max_batch: Optional[int] = None,
        check_finite: bool = False,
        request_timeout: Optional[float] = None,
    ) -> None:
        super().__init__(
            self._ship, name=name, capacity_tags=(tag,),
            max_batch=max_batch, check_finite=check_finite,
        )
        self.transport = transport
        self.tag = tag
        self.request_timeout = request_timeout

    def _ship(self, stacked: np.ndarray):  # pragma: no cover - batch_call
        raise RuntimeError("RemoteBatchServer dispatches through batch_call")

    def batch_call(self, thetas: Sequence[Any]) -> List[Any]:
        stacked = np.stack([np.asarray(t) for t in thetas])
        rows, service_s = self.transport.eval_batch(
            self.tag, stacked, timeout=self.request_timeout
        )
        self.last_service_s = service_s
        if self.check_finite:
            rows = [
                r
                if isinstance(r, BaseException) or np.all(np.isfinite(r))
                else FloatingPointError(
                    f"non-finite result for batch member {i} on '{self.name}'"
                )
                for i, r in enumerate(rows)
            ]
        return rows

    def probe(self) -> bool:
        """Heartbeat across the transport (see :meth:`RemoteServer.probe`)."""
        return self.transport.probe()


def remote_servers_for(
    transport: _Transport,
    *,
    tags: Optional[Sequence[str]] = None,
    batch: bool = True,
    max_batch: Optional[int] = None,
    name_prefix: str = "remote",
    request_timeout: Optional[float] = None,
) -> List[Server]:
    """One remote server per exported tag (asks the shell via ``info`` when
    ``tags`` is not given) — the client half of a two-process deployment."""
    if tags is None:
        tags = transport.info().get("tags", [])
    out: List[Server] = []
    for tag in tags:
        if batch:
            out.append(
                RemoteBatchServer(
                    transport, tag, name=f"{name_prefix}-{tag}",
                    max_batch=max_batch, request_timeout=request_timeout,
                )
            )
        else:
            out.append(
                RemoteServer(
                    transport, tag, name=f"{name_prefix}-{tag}",
                    request_timeout=request_timeout,
                )
            )
    return out
