"""Server-side shell: export a pool of :class:`repro_torch.balancer.types.Server`
objects over a socket (the paper's UM-Bridge deployment shape).

A :class:`ServerShell` owns a listener (and/or in-process socketpair
endpoints for hermetic tests), routes incoming calls to the wrapped
servers by tag, and speaks **two protocols on one port**, negotiated by
the first eight bytes of each connection:

* connections opening with :data:`repro_torch.net.framing.MAGIC` use the binary
  framing mode (length-prefixed header + raw little-endian array bytes,
  pipelined: frames carry ids and responses may complete out of order —
  each frame is executed on the shell's worker pool and written back
  under the connection's write lock as soon as it finishes);
* anything else is parsed as HTTP/1.1 and served UM-Bridge-style JSON:
  ``GET /Info`` (model names = exported tags), ``POST /InputSizes`` /
  ``POST /OutputSizes``, and ``POST /Evaluate`` with
  ``{"name": tag, "input": [[...], ...]}`` — a list of B parameter
  vectors evaluates as one batch, so coalesced batches stay one round
  trip in either mode.

Error semantics mirror the in-process dispatcher exactly: a per-member
failure (an ``Exception`` result row, ``check_finite``) crosses the wire
in the response header's ``errors`` map and fails only that member on
the client; a whole-call fault answers an ``error`` frame, which the
client raises into the dispatcher's server-death/requeue path.

``stop()`` drains gracefully: the listener closes, every connection's
read side shuts down (in-flight frames finish and their responses are
written), then threads and the worker pool are joined — zero leaked
threads, verified in tests.  ``kill()`` is the abrupt variant used by
the death-path tests: sockets are torn down mid-flight so clients see a
reset, exactly like a machine loss.  See DESIGN.md §11.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .framing import MAGIC, PROTOCOL_VERSION, encode_error, recv_frame, send_frame


def _as_rows(results: Sequence[Any]) -> Tuple[np.ndarray, Dict[str, List[str]]]:
    """Stack per-member results into one wire array + an error map.

    ``Exception`` entries keep their index in ``errors`` and contribute a
    zero row (never read by the client) so the stacked payload stays
    rectangular.
    """
    errors: Dict[str, List[str]] = {}
    good: Optional[np.ndarray] = None
    for i, r in enumerate(results):
        if isinstance(r, BaseException):
            errors[str(i)] = encode_error(r)
        elif good is None:
            good = np.asarray(r)
    if good is None:  # every member failed: shape is irrelevant, dtype isn't
        return np.zeros((len(results), 0), dtype="<f4"), errors
    rows = [
        np.zeros_like(good) if isinstance(r, BaseException) else np.asarray(r)
        for r in results
    ]
    return np.stack(rows), errors


class ServerShell:
    """Export ``servers`` over a socket (binary framing + UM-Bridge JSON).

    ``host=None`` keeps the shell loopback-only: no TCP listener is bound
    and clients connect through :meth:`connect` (an in-process
    ``socketpair``) — the hermetic transport tier-1 tests use.  With a
    ``host`` the shell additionally listens on ``(host, port)``; port 0
    picks an ephemeral port (see :attr:`address`).

    Each wrapped server is called under its own lock — one in-flight call
    per server, the same single-worker-per-server discipline the
    in-process dispatcher enforces — while different servers evaluate
    concurrently on the shell's worker pool.  ``input_sizes`` /
    ``output_sizes`` (per-tag) feed the UM-Bridge introspection endpoints.
    """

    def __init__(
        self,
        servers: Sequence[Any],
        *,
        host: Optional[str] = None,
        port: int = 0,
        max_workers: Optional[int] = None,
        name: str = "shell",
        input_sizes: Optional[Dict[str, List[int]]] = None,
        output_sizes: Optional[Dict[str, List[int]]] = None,
    ) -> None:
        if not servers:
            raise ValueError("ServerShell needs at least one server to export")
        self.name = name
        self._servers = list(servers)
        self._by_tag: Dict[str, List[Any]] = {}
        self._rr: Dict[str, int] = {}  # round-robin cursor per tag
        for s in self._servers:
            tags = s.capacity_tags or ("",)
            for tag in tags:
                self._by_tag.setdefault(tag, []).append(s)
        self._server_locks = {id(s): threading.Lock() for s in self._servers}
        self._host = host
        self._port = port
        self._input_sizes = dict(input_sizes or {})
        self._output_sizes = dict(output_sizes or {})
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._stopping = False
        self._started = False
        self._inflight = 0
        self._idle = threading.Condition(self._lock)
        # Set when stop()'s drain deadline expires: stuck handlers are
        # abandoned — connection loops stop waiting for their responses
        # and the worker pool is shut down without joining them.
        self._abandoned = threading.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or max(4, len(self._servers)),
            thread_name_prefix=f"{name}-exec",
        )

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServerShell":
        if self._started:
            return self
        self._started = True
        if self._host is not None:
            self._listener = socket.create_server(
                (self._host, self._port), backlog=16
            )
            # A timeout keeps the accept loop checking the stopping flag:
            # close() alone does not reliably wake a thread parked in
            # accept(), and shutdown() on a listening socket is not
            # portable — polling every 200 ms is.
            self._listener.settimeout(0.2)
            self._port = self._listener.getsockname()[1]
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"{self.name}-accept", daemon=True
            )
            self._accept_thread.start()
        return self

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        """The TCP ``(host, port)`` clients dial, or None (loopback-only)."""
        if self._host is None:
            return None
        return (self._host, self._port)

    def connect(self) -> socket.socket:
        """In-process loopback dial: returns the client end of a fresh
        ``socketpair`` whose server end joins the shell's connection set —
        the hermetic transport (no TCP stack, deterministic, sandbox-safe).
        """
        with self._lock:
            if self._stopping or not self._started:
                raise ConnectionRefusedError(f"shell '{self.name}' is not serving")
            client, server_end = socket.socketpair()
            self._spawn_conn_locked(server_end)
        return client

    def dial(self) -> socket.socket:
        """Dial this shell the way a remote client would: TCP when bound,
        socketpair otherwise (what tests toggle with ``REPRO_NET_TCP``)."""
        if self._host is not None:
            return socket.create_connection((self._host, self._port), timeout=10)
        return self.connect()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful shutdown: stop accepting, let in-flight frames finish,
        join every thread.  With ``drain=False`` behaves like :meth:`kill`.

        The drain is **bounded**: a handler still running ``timeout``
        seconds after the drain began (wedged solver, deadlocked model) is
        escalated past — every socket is reset so clients see a clean
        connection loss (their requests requeue via the dispatcher's
        death path) and the stuck handler is *abandoned*: its worker
        thread keeps running, but nothing waits for it and its eventual
        response is discarded.  Without the escalation one wedged handler
        would park ``stop()`` forever.
        """
        if not drain:
            self.kill()
            return
        with self._lock:
            self._stopping = True
            conns = list(self._conns)
        self._close_listener()
        for c in conns:  # EOF the read side: handlers finish, then exit
            try:
                c.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight > 0 and time.monotonic() < deadline:
                self._idle.wait(deadline - time.monotonic())
            stuck = self._inflight > 0
        if not stuck:
            self._teardown()
            return
        self._reset_conns()  # escalate: clients see connection loss now
        self._teardown(wait=False)

    def kill(self) -> None:
        """Abrupt death (the failure-path tests' machine loss): every
        socket is reset mid-flight; in-flight results are discarded."""
        with self._lock:
            self._stopping = True
        self._close_listener()
        self._reset_conns()
        self._teardown()

    def _reset_conns(self) -> None:
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _teardown(self, wait: bool = True) -> None:
        """Join every thread the shell started.  ``wait=False`` is the
        abandoned-handler path: connection loops are released from their
        pending-response waits and the pool is shut down without joining
        its (stuck) workers — their late results go nowhere."""
        if not wait:
            self._abandoned.set()
        self._pool.shutdown(wait=wait, cancel_futures=not wait)
        if self._accept_thread is not None:
            self._accept_thread.join()
            self._accept_thread = None
        with self._lock:
            threads = list(self._conn_threads)
        for t in threads:
            t.join()
        with self._lock:
            for c in self._conns:
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()
            self._conn_threads.clear()

    def __enter__(self) -> "ServerShell":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- connection plumbing -------------------------------------------------
    def _accept_loop(self) -> None:
        listener = self._listener
        assert listener is not None
        while True:
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                with self._lock:
                    if self._stopping:
                        return
                continue
            except OSError:
                return  # listener closed: shutdown
            with self._lock:
                if self._stopping:
                    conn.close()
                    return
                self._spawn_conn_locked(conn)

    def _spawn_conn_locked(self, conn: socket.socket) -> None:
        self._conns.append(conn)
        t = threading.Thread(
            target=self._serve_conn,
            args=(conn,),
            name=f"{self.name}-conn-{len(self._conn_threads)}",
            daemon=True,
        )
        self._conn_threads.append(t)
        t.start()

    def _close_listener(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None

    def _serve_conn(self, conn: socket.socket) -> None:
        """Negotiate the protocol from the first bytes, then serve."""
        try:
            preamble = b""
            while len(preamble) < len(MAGIC):
                chunk = conn.recv(len(MAGIC) - len(preamble))
                if not chunk:
                    return
                preamble += chunk
                if not MAGIC.startswith(preamble):
                    break
            if preamble == MAGIC:
                self._serve_binary(conn)
            else:
                self._serve_http(conn, preamble)
        except (OSError, ConnectionError, ValueError, json.JSONDecodeError):
            pass  # connection died or spoke garbage: drop it
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    # -- request execution (shared by both protocols) ------------------------
    def _pick(self, tag: str):
        pool = self._by_tag.get(tag) or self._by_tag.get("")
        if not pool:
            raise KeyError(f"no exported server accepts tag '{tag}'")
        with self._lock:  # round-robin across same-tag replicas
            i = self._rr.get(tag, 0)
            self._rr[tag] = i + 1
        return pool[i % len(pool)]

    def _evaluate(
        self, tag: str, members: List[Any]
    ) -> Tuple[np.ndarray, Dict[str, List[str]], float]:
        """Evaluate ``members`` (a list of thetas) as one batch on the
        server routed for ``tag``; returns (stacked rows, member errors,
        service seconds).  Raises on whole-call faults."""
        server = self._pick(tag)
        t0 = time.monotonic()
        with self._server_locks[id(server)]:
            if server.batch_fn is not None:
                results = server.batch_call(members)
            elif len(members) == 1:
                results = [server.fn(members[0])]
            else:
                # A per-request server still answers a shipped batch in one
                # round trip; member faults scatter instead of killing it.
                results = []
                for m in members:
                    try:
                        results.append(server.fn(m))
                    except Exception as exc:  # noqa: BLE001 - member channel
                        results.append(exc)
        service_s = time.monotonic() - t0
        stacked, errors = _as_rows(results)
        return stacked, errors, service_s

    @property
    def tags(self) -> List[str]:
        return sorted(self._by_tag)

    def _enter_call(self) -> bool:
        with self._lock:
            if self._stopping:
                return False
            self._inflight += 1
        return True

    def _exit_call(self) -> None:
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    # -- binary protocol -----------------------------------------------------
    def _serve_binary(self, conn: socket.socket) -> None:
        write_lock = threading.Lock()
        # Per-connection in-flight frame count: the read loop may see EOF
        # (client close, drain's SHUT_RD) while frames it already submitted
        # are still computing on the pool — the connection must stay open
        # until their responses have shipped, so the loop parks on this
        # condition before handing the socket back to _serve_conn's close.
        pending_cv = threading.Condition()
        pending = [0]
        try:
            while True:
                header, arrays = recv_frame(conn)
                if header is None:
                    return  # clean EOF (client closed, or drain SHUT_RD)
                if not self._enter_call():
                    return
                with pending_cv:
                    pending[0] += 1
                self._pool.submit(
                    self._run_binary,
                    conn, write_lock, header, arrays, pending_cv, pending,
                )
        finally:
            # Poll the abandoned flag: a stuck handler never decrements
            # pending, and this loop must not outlive stop()'s escalation.
            with pending_cv:
                while pending[0] and not self._abandoned.is_set():
                    pending_cv.wait(0.2)

    def _run_binary(
        self,
        conn: socket.socket,
        write_lock: threading.Lock,
        header: Dict[str, Any],
        arrays: List[np.ndarray],
        pending_cv: threading.Condition,
        pending: List[int],
    ) -> None:
        rid = header.get("id")
        try:
            try:
                op = header.get("op")
                if op == "info":
                    reply: Dict[str, Any] = {
                        "id": rid,
                        "op": "info",
                        "name": self.name,
                        "protocol": PROTOCOL_VERSION,
                        "tags": self.tags,
                    }
                    payload: List[np.ndarray] = []
                elif op == "probe":
                    # Liveness heartbeat for the balancer's health monitor:
                    # answered from the frame loop's worker without touching
                    # any exported server (a probe must not queue behind a
                    # long solve on the server lock).
                    reply = {"id": rid, "op": "probe", "ok": True,
                             "name": self.name}
                    payload = []
                elif op in ("eval", "eval_batch"):
                    theta = arrays[0]
                    members = list(theta) if op == "eval_batch" else [theta]
                    stacked, errors, service_s = self._evaluate(
                        header.get("tag", ""), members
                    )
                    if op == "eval":
                        stacked = stacked[0]
                    reply = {"id": rid, "op": "result", "service_s": service_s}
                    if errors:
                        reply["errors"] = errors
                    payload = [stacked]
                else:
                    raise ValueError(f"unknown op '{op}'")
            except Exception as exc:  # noqa: BLE001 - whole-call error frame
                reply = {"id": rid, "op": "error", "error": encode_error(exc)}
                payload = []
            try:
                with write_lock:  # pipelined responses never interleave bytes
                    send_frame(conn, reply, payload)
            except OSError:
                pass  # client gone: nothing to tell it
        finally:
            # Booked only after the response shipped (or provably cannot):
            # stop(drain) waits on _inflight, so the global count must cover
            # the send, and the read loop waits on the per-conn count before
            # the socket closes.
            self._exit_call()
            with pending_cv:
                pending[0] -= 1
                pending_cv.notify_all()

    # -- UM-Bridge HTTP/JSON protocol ----------------------------------------
    def _serve_http(self, conn: socket.socket, prefix: bytes) -> None:
        buf = prefix
        while True:
            # read one request head
            while b"\r\n\r\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                buf += chunk
            head, buf = buf.split(b"\r\n\r\n", 1)
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, path, _version = lines[0].split(" ", 2)
            except ValueError:
                return
            headers = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            clen = int(headers.get("content-length", 0))
            while len(buf) < clen:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                buf += chunk
            body, buf = buf[:clen], buf[clen:]
            if not self._enter_call():
                return
            try:
                status, reply = self._http_route(method, path, body)
            finally:
                self._exit_call()
            rb = json.dumps(reply).encode()
            conn.sendall(
                (
                    f"HTTP/1.1 {status}\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(rb)}\r\n"
                    "Connection: keep-alive\r\n\r\n"
                ).encode("latin-1")
                + rb
            )
            if headers.get("connection", "").lower() == "close":
                return

    def _http_route(
        self, method: str, path: str, body: bytes
    ) -> Tuple[str, Dict[str, Any]]:
        if method == "GET" and path == "/Info":
            return "200 OK", {
                "protocolVersion": 1.0,
                "name": self.name,
                "models": self.tags,
            }
        if method != "POST":
            return "404 Not Found", {"error": f"unknown route {method} {path}"}
        req = json.loads(body or b"{}")
        tag = req.get("name", "")
        if path == "/InputSizes":
            return "200 OK", {"inputSizes": self._input_sizes.get(tag, [])}
        if path == "/OutputSizes":
            return "200 OK", {"outputSizes": self._output_sizes.get(tag, [])}
        if path == "/Evaluate":
            members = [np.asarray(v, dtype=np.float64) for v in req.get("input", ())]
            if not members:
                return "400 Bad Request", {
                    "error": {"type": "InvalidInput", "message": "empty input"}
                }
            try:
                stacked, errors, service_s = self._evaluate(tag, members)
            except Exception as exc:  # noqa: BLE001 - whole-call error reply
                return "500 Internal Server Error", {
                    "error": {"type": type(exc).__name__, "message": str(exc)}
                }
            out = [np.atleast_1d(row).tolist() for row in stacked]
            reply: Dict[str, Any] = {"output": out, "time": service_s}
            if errors:
                reply["memberErrors"] = errors
            return "200 OK", reply
        return "404 Not Found", {"error": f"unknown route {method} {path}"}


def export_servers(servers: Sequence[Any], **kwargs: Any) -> ServerShell:
    """Build and start a :class:`ServerShell` in one call."""
    return ServerShell(servers, **kwargs).start()
