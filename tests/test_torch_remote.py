"""The port's network-transparent serving (``repro_torch.net``), as the
reference's ``tests/test_remote.py`` holds ``repro.net``.

Hermetic by default: every connection is an in-process ``socketpair``
(``ServerShell.dial`` without a TCP bind).  Set ``REPRO_NET_TCP=1`` to run
the same tests over real loopback TCP sockets.  Then the Tōhoku level pools
over the wire: ``launch.export``'s shell over a tiny CPU hierarchy,
``launch.tsunami.run`` against it in both protocols, and
``make_remote_level_servers`` closing each transport once.
"""
import dataclasses
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.balancer import (
    BatchServer,
    LoadBalancer,
    RequestCancelled,
    Server,
    gather,
)
from repro_torch.net import (
    ServerShell,
    TransportError,
    make_transport,
    recv_frame,
    remote_servers_for,
    send_frame,
)
from repro_torch.configs.tohoku_mlda import CPU
from repro_torch.launch.export import build_shell, export_pools
from repro_torch.launch.tsunami import run
from repro_torch.swe import close_transports, local_level_servers, make_remote_level_servers

USE_TCP = os.environ.get("REPRO_NET_TCP") == "1"


def _f(stacked):
    """The reference forward: rows of 2*theta + [0, 1, 2, ...] in fp32."""
    stacked = np.asarray(stacked, dtype=np.float32)
    return 2.0 * stacked + np.arange(
        stacked.shape[-1], dtype=np.float32
    )


def make_shell(servers, **kw):
    if USE_TCP:
        kw.setdefault("host", "127.0.0.1")
        kw.setdefault("port", 0)
    return ServerShell(servers, **kw).start()


def local_pool(check_finite=False):
    return [
        BatchServer(
            _f, name="pool-0", capacity_tags=("gp",), check_finite=check_finite
        )
    ]


@pytest.fixture
def leak_check():
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        leaked = [
            t for t in threading.enumerate()
            if t not in before and t.is_alive()
        ]
        if not leaked:
            return
        time.sleep(0.02)
    raise AssertionError(f"leaked threads: {[t.name for t in leaked]}")


# -- framing -----------------------------------------------------------------
def test_framing_roundtrip_bit_identical():
    a, b = socket.socketpair()
    try:
        arrays = [
            np.arange(12, dtype=np.float32).reshape(3, 4),
            np.array([], dtype="<f8"),
            (np.arange(5, dtype=np.int64) * -3),
        ]
        send_frame(a, {"op": "eval", "tag": "t"}, arrays)
        header, out = recv_frame(b)
        assert header["op"] == "eval" and header["tag"] == "t"
        assert len(out) == len(arrays)
        for sent, got in zip(arrays, out):
            assert got.dtype == np.dtype(sent.dtype.str).newbyteorder("=")
            assert got.shape == sent.shape
            assert got.tobytes() == np.ascontiguousarray(sent).tobytes()
        # clean EOF at a frame boundary -> (None, [])
        a.close()
        assert recv_frame(b) == (None, [])
    finally:
        b.close()


def test_framing_large_payload_crosses_whole():
    # Above SMALL_FRAME the arrays are written per-buffer (zero-copy path).
    a, b = socket.socketpair()
    got = {}

    def rx():
        got["frame"] = recv_frame(b)

    t = threading.Thread(target=rx)
    t.start()
    big = np.random.default_rng(0).random((512, 257)).astype(np.float32)
    send_frame(a, {"op": "eval_batch", "tag": "x"}, [big])
    t.join(5)
    header, arrays = got["frame"]
    assert arrays[0].shape == big.shape
    np.testing.assert_array_equal(arrays[0], big)
    a.close()
    b.close()


# -- binary transport: correctness ------------------------------------------
def test_remote_eval_bit_identical(leak_check):
    shell = make_shell(local_pool(), name="bit")
    with make_transport(shell, binary=True) as tr:
        theta = np.array([1.5, -2.25, 8.0], dtype=np.float32)
        row, service_s = tr.eval_single("gp", theta)
        expect = _f(theta[None])[0]
        assert row.tobytes() == expect.tobytes()  # fp32 bit-identity
        assert service_s >= 0.0
        stacked = np.linspace(-4, 4, 24, dtype=np.float32).reshape(8, 3)
        rows, _ = tr.eval_batch("gp", stacked)
        ref = _f(stacked)
        for i, r in enumerate(rows):
            assert r.tobytes() == ref[i].tobytes()
    shell.stop()


def test_info_reports_tags(leak_check):
    shell = make_shell(local_pool(), name="info")
    with make_transport(shell, binary=True) as tr:
        assert tr.info()["tags"] == ["gp"]
    shell.stop()


def test_member_error_scatter_over_the_wire(leak_check):
    # check_finite on the REMOTE side: the poisoned member comes back as a
    # FloatingPointError row, its batch mates bit-identical.
    shell = make_shell(local_pool(check_finite=True), name="scatter")
    with make_transport(shell, binary=True) as tr:
        stacked = np.ones((4, 3), dtype=np.float32)
        stacked[2] = np.nan
        rows, _ = tr.eval_batch("gp", stacked)
        assert isinstance(rows[2], FloatingPointError)
        ref = _f(stacked)
        for i in (0, 1, 3):
            assert rows[i].tobytes() == ref[i].tobytes()
    shell.stop()


def test_unknown_tag_is_a_call_error_not_transport_death(leak_check):
    shell = make_shell(local_pool(), name="badtag")
    with make_transport(shell, binary=True) as tr:
        with pytest.raises((KeyError, RuntimeError)):
            tr.eval_single("nope", np.zeros(3, dtype=np.float32))
        # the connection survived: a good call still works
        row, _ = tr.eval_single("gp", np.zeros(3, dtype=np.float32))
        assert row.shape == (3,)
    shell.stop()


def test_pipelining_many_inflight_one_connection(leak_check):
    delay = 0.05
    n = 8

    def slow(stacked):
        time.sleep(delay)
        return _f(stacked)

    # n replica servers: the shell serializes calls per server (the
    # one-worker-per-server discipline) but runs different replicas
    # concurrently, so n pipelined frames on ONE connection overlap.
    shell = make_shell(
        [
            BatchServer(slow, name=f"s{i}", capacity_tags=("gp",))
            for i in range(n)
        ],
        name="pipe",
        max_workers=n,
    )
    with make_transport(shell, binary=True, n_connections=1) as tr:
        results = [None] * n
        t0 = time.monotonic()

        def call(i):
            theta = np.full(3, float(i), dtype=np.float32)
            results[i] = tr.eval_single("gp", theta)[0]

        threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        wall = time.monotonic() - t0
    shell.stop()
    for i, row in enumerate(results):
        expect = _f(np.full((1, 3), float(i), dtype=np.float32))[0]
        assert row.tobytes() == expect.tobytes()
    # n serial round trips cost >= n * delay even with an instant wire;
    # pipelined on one connection they overlap across the replicas.
    assert wall < 0.5 * n * delay, f"not pipelined: {wall:.3f}s"


# -- UM-Bridge JSON interop ---------------------------------------------------
def test_json_transport_matches_binary(leak_check):
    shell = make_shell(local_pool(), name="json")
    theta = np.array([0.5, 1.5, -3.0], dtype=np.float32)
    with make_transport(shell, binary=True) as btr:
        bin_row, _ = btr.eval_single("gp", theta)
    with make_transport(shell, binary=False) as jtr:
        assert jtr.info()["tags"] == ["gp"]
        json_row, _ = jtr.eval_single("gp", theta)
        np.testing.assert_allclose(json_row, bin_row, rtol=1e-6)
    shell.stop()


@pytest.mark.parametrize("binary", [True, False])
def test_fp32_rows_bit_identical_in_both_protocols(leak_check, binary):
    """fp32 rows cross both wire modes with their bits: binary framing ships
    the raw bytes, UM-Bridge JSON the shortest repr of each value, which
    parses back to the same float."""
    shell = make_shell(local_pool(), name=f"bits-{binary}")
    rng = np.random.default_rng(7)
    stacked = (rng.standard_normal((8, 3)) * 10.0 ** rng.integers(-30, 30, (8, 3)))
    stacked = stacked.astype(np.float32)
    with make_transport(shell, binary=binary) as tr:
        rows, _ = tr.eval_batch("gp", stacked)
    ref = _f(stacked)
    for i, r in enumerate(rows):
        assert np.asarray(r, dtype=np.float32).tobytes() == ref[i].tobytes()
    shell.stop()


def test_json_member_errors_cross_as_memberErrors(leak_check):
    shell = make_shell(local_pool(check_finite=True), name="json-err")
    with make_transport(shell, binary=False) as jtr:
        stacked = np.ones((3, 3), dtype=np.float32)
        stacked[1] = np.inf
        rows, _ = jtr.eval_batch("gp", stacked)
        assert isinstance(rows[1], FloatingPointError)
        ref = _f(stacked)
        np.testing.assert_allclose(rows[0], ref[0], rtol=1e-6)
        np.testing.assert_allclose(rows[2], ref[2], rtol=1e-6)
    shell.stop()


def test_umbridge_http_with_stdlib_client(leak_check):
    # A foreign UM-Bridge client is plain HTTP: use http.client directly,
    # over a loopback TCP endpoint (http.client dials host:port).
    import http.client
    import json as _json

    shell = ServerShell(local_pool(), name="umb", host="127.0.0.1", port=0).start()
    host, port = shell.address
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("GET", "/Info")
        info = _json.loads(conn.getresponse().read())
        assert info["models"] == ["gp"]
        body = _json.dumps({"name": "gp", "input": [[1.0, 2.0, 3.0]]})
        conn.request("POST", "/Evaluate", body=body)
        out = _json.loads(conn.getresponse().read())
        np.testing.assert_allclose(
            out["output"][0], _f(np.array([[1.0, 2.0, 3.0]]))[0], rtol=1e-6
        )
    finally:
        conn.close()
    shell.stop()


# -- through the dispatcher ---------------------------------------------------
def test_balancer_over_remote_bit_identical_to_inprocess(leak_check):
    thetas = np.random.default_rng(1).random((24, 3)).astype(np.float32)
    # in-process reference
    with LoadBalancer(local_pool()) as lb:
        ref = [lb.submit(t, tag="gp", batchable=True) for t in thetas]
    shell = make_shell(local_pool(), name="via-lb")
    tr = make_transport(shell, binary=True)
    remotes = remote_servers_for(tr, max_batch=8)
    with LoadBalancer(remotes, batch_window_s=0.002, max_batch=8) as lb:
        reqs = lb.submit_many(list(thetas), tag="gp", batchable=True)
        gather(reqs)
        for req, expect in zip(reqs, ref):
            assert req.error is None
            assert req.result.tobytes() == expect.tobytes()
    tr.close()
    shell.stop()


def test_wire_split_telemetry_booked(leak_check):
    shell = make_shell(local_pool(), name="wire")
    tr = make_transport(shell, binary=True)
    with LoadBalancer(remote_servers_for(tr)) as lb:
        for i in range(8):
            lb.submit(np.full(3, float(i), dtype=np.float32), tag="gp")
        split = lb.summary()["wire_split"]
        assert len(split) == 1
        (stats,) = split.values()
        assert stats["calls"] == 8
        assert stats["wire_s"] >= 0.0 and stats["service_s"] > 0.0
        (row,) = lb.stats_table()
        assert row["wire_ewma_s"] is not None
    tr.close()
    shell.stop()


def test_server_death_mid_batch_requeues_on_survivor(leak_check):
    """Kill a remote shell mid-batch: every in-flight member must requeue
    and complete on the surviving replica, retries bounded, no leaks."""
    release = threading.Event()
    entered = threading.Event()

    def doomed(stacked):
        entered.set()
        release.wait(5)
        return _f(stacked)  # never ships: the socket is reset first

    shell_a = make_shell(
        [BatchServer(doomed, name="a0", capacity_tags=("gp",))], name="doomed"
    )
    shell_b = make_shell(local_pool(), name="survivor")
    tr_a = make_transport(shell_a, binary=True, retries=0)
    tr_b = make_transport(shell_b, binary=True)
    ra = remote_servers_for(tr_a, tags=["gp"], name_prefix="ra")[0]
    rb = remote_servers_for(tr_b, tags=["gp"], name_prefix="rb")[0]
    lb = LoadBalancer([ra, rb], batch_window_s=0.01, max_batch=8, max_retries=2)
    thetas = np.arange(24, dtype=np.float32).reshape(8, 3)
    reqs = lb.submit_many(list(thetas), tag="gp", batchable=True)
    assert entered.wait(5), "doomed shell never got a batch"
    shell_a.kill()  # machine loss: sockets reset, in-flight results lost
    release.set()
    gather(reqs, timeout=20)
    ref = _f(thetas)
    for i, req in enumerate(reqs):
        assert req.error is None, f"member {i}: {req.error}"
        assert req.result.tobytes() == ref[i].tobytes()
        assert req.retries <= lb.max_retries
    assert ra.dead and not rb.dead
    assert any(r.retries > 0 for r in reqs)  # the killed members retried
    lb.shutdown()
    tr_a.close()
    tr_b.close()
    shell_b.stop()


def test_transport_retry_then_exhaustion(leak_check):
    shell = make_shell(local_pool(), name="gone")
    tr = make_transport(shell, binary=True, retries=1, backoff_s=0.01)
    row, _ = tr.eval_single("gp", np.zeros(3, dtype=np.float32))
    assert row.shape == (3,)
    shell.kill()
    with pytest.raises(TransportError):
        tr.eval_single("gp", np.zeros(3, dtype=np.float32))
    tr.close()


# -- client-side deadlines -----------------------------------------------------
def test_cancel_queued_request(leak_check):
    gate = threading.Event()

    def slow(theta):
        gate.wait(5)
        return theta

    with LoadBalancer([Server(slow, name="s")]) as lb:
        r1 = lb.submit_async(1.0)
        time.sleep(0.05)  # let r1 reach the server
        r2 = lb.submit_async(2.0)
        assert r2.cancel() is True
        assert isinstance(r2.error, RequestCancelled)
        assert r2.done.is_set()
        assert r2.cancel() is False  # idempotent: already completed
        gate.set()
        assert lb.result(r1, timeout=5) == 1.0
        assert r1.cancel() is False  # completed requests cannot cancel


def test_gather_deadline_cancels_pending(leak_check):
    gate = threading.Event()

    def slow(theta):
        gate.wait(5)
        return theta

    with LoadBalancer([Server(slow, name="s")]) as lb:
        reqs = [lb.submit_async(float(i)) for i in range(4)]
        with pytest.raises(TimeoutError):
            gather(reqs, timeout=0.1, cancel_pending=True)
        # the in-flight head is abandoned (still running), the queued tail
        # was reclaimed with RequestCancelled
        cancelled = [r for r in reqs if isinstance(r.error, RequestCancelled)]
        assert len(cancelled) == 3
        gate.set()
        assert lb.result(reqs[0], timeout=5) == 0.0


def test_result_cancel_on_timeout(leak_check):
    gate = threading.Event()

    def slow(theta):
        gate.wait(5)
        return theta

    with LoadBalancer([Server(slow, name="s")]) as lb:
        r1 = lb.submit_async(1.0)
        time.sleep(0.05)
        r2 = lb.submit_async(2.0)
        with pytest.raises(TimeoutError):
            lb.result(r2, timeout=0.05, cancel_on_timeout=True)
        assert isinstance(r2.error, RequestCancelled)
        gate.set()
        assert lb.result(r1, timeout=5) == 1.0


def test_remote_deadline_abandons_cleanly(leak_check):
    # A request timing out over the wire kills that connection (the
    # pipelined stream can't resync) but the transport redials: the next
    # call succeeds and nothing leaks.
    release = threading.Event()

    def stall(stacked):
        release.wait(2)
        return _f(stacked)

    shell = make_shell(
        [BatchServer(stall, name="s", capacity_tags=("gp",))], name="stall",
        max_workers=4,
    )
    tr = make_transport(shell, binary=True, retries=0)
    with pytest.raises(TransportError):
        tr.eval_single("gp", np.zeros(3, dtype=np.float32), timeout=0.05)
    release.set()
    row, _ = tr.eval_single("gp", np.zeros(3, dtype=np.float32), timeout=5)
    assert row.shape == (3,)
    tr.close()
    shell.stop()


# -- lifecycle ----------------------------------------------------------------
def test_graceful_drain_ships_inflight_results(leak_check):
    started = threading.Event()

    def slowish(stacked):
        started.set()
        time.sleep(0.1)
        return _f(stacked)

    shell = make_shell(
        [BatchServer(slowish, name="s", capacity_tags=("gp",))], name="drain"
    )
    tr = make_transport(shell, binary=True)
    out = {}

    def call():
        out["row"] = tr.eval_single("gp", np.ones(3, dtype=np.float32))[0]

    t = threading.Thread(target=call)
    t.start()
    assert started.wait(5)
    shell.stop(drain=True)  # must wait for the in-flight eval to ship
    t.join(5)
    expect = _f(np.ones((1, 3), dtype=np.float32))[0]
    assert out["row"].tobytes() == expect.tobytes()
    tr.close()


def test_drain_deadline_abandons_stuck_handler(leak_check):
    """A wedged handler cannot park stop(): past the drain deadline the
    shell resets its sockets and abandons the worker (satellite of
    DESIGN.md §12's fault model)."""
    entered = threading.Event()
    release = threading.Event()

    def stuck(stacked):
        entered.set()
        release.wait(30)
        return _f(stacked)

    shell = make_shell(
        [BatchServer(stuck, name="s", capacity_tags=("gp",))], name="stuck"
    )
    tr = make_transport(shell, binary=True, retries=0)

    def call():
        try:
            tr.eval_single("gp", np.ones(3, dtype=np.float32))
        except (TransportError, ConnectionError):
            pass  # the client sees a clean connection loss

    t = threading.Thread(target=call)
    t.start()
    try:
        assert entered.wait(5)
        t0 = time.monotonic()
        shell.stop(drain=True, timeout=0.2)  # handler never returns
        assert time.monotonic() - t0 < 5.0, "stop() parked on a wedged handler"
        t.join(5)
        assert not t.is_alive()
    finally:
        release.set()  # unwedge the abandoned worker so it can run out
        t.join(5)
        tr.close()


# -- health probes over the wire ----------------------------------------------
def test_probe_heartbeat_binary_and_json(leak_check):
    shell = make_shell(local_pool(), name="probe")
    with make_transport(shell, binary=True) as btr:
        assert btr.probe()
    with make_transport(shell, binary=False) as jtr:
        assert jtr.probe()
    shell.stop()


def test_remote_server_probe_tracks_shell_liveness(leak_check):
    shell = make_shell(local_pool(), name="probe-live")
    tr = make_transport(shell, binary=True)
    server = remote_servers_for(tr)[0]
    assert server.probe()  # alive: the heartbeat frame round-trips
    shell.kill()
    assert not server.probe()  # dead: single attempt, no retry ladder
    tr.close()


def test_probe_does_not_disturb_pipelined_traffic(leak_check):
    delay = 0.05

    def slow(stacked):
        time.sleep(delay)
        return _f(stacked)

    shell = make_shell(
        [BatchServer(slow, name="s", capacity_tags=("gp",))], name="probe-mix"
    )
    with make_transport(shell, binary=True, n_connections=1) as tr:
        out = {}

        def call():
            out["row"] = tr.eval_single("gp", np.ones(3, dtype=np.float32))[0]

        t = threading.Thread(target=call)
        t.start()
        time.sleep(delay / 5)
        # probe answered from the frame loop while the eval is in flight
        assert tr.probe()
        t.join(5)
        expect = _f(np.ones((1, 3), dtype=np.float32))[0]
        assert out["row"].tobytes() == expect.tobytes()
    shell.stop()


# -- redial backoff: capped + jittered ----------------------------------------
def test_backoff_delays_capped_and_jittered_downward(monkeypatch):
    from repro_torch.net import BinaryTransport

    def refuse():
        raise OSError("connection refused")

    delays = []
    monkeypatch.setattr(time, "sleep", delays.append)
    tr = BinaryTransport(
        refuse, retries=4, backoff_s=0.1, backoff_cap_s=0.25, backoff_jitter=0.5
    )
    with pytest.raises(TransportError):
        tr.eval_single("gp", np.zeros(3, dtype=np.float32))
    # deterministic schedule 0.1, 0.2, 0.4->cap, 0.8->cap; jitter only
    # shortens (never lengthens) each delay, by at most backoff_jitter.
    schedule = [0.1, 0.2, 0.25, 0.25]
    assert len(delays) == len(schedule)
    for observed, nominal in zip(delays, schedule):
        assert 0.5 * nominal <= observed <= nominal
    tr.close()


# -- the Tōhoku level pools over the wire --------------------------------------
TINY = dataclasses.replace(
    CPU, coarse_grid=(16, 16), fine_grid=(24, 24), t_end_s=1200.0,
    gp_train_points=16, gp_opt_steps=8, n_chains=2, n_fine_samples=3,
    subchain_lengths=(3, 2), max_batch=4,
)


@pytest.fixture(scope="module")
def exported():
    """``launch.export``'s shell over the tiny CPU hierarchy, on loopback
    TCP (``run`` dials ``host:port`` endpoints), and the in-process run."""
    shell = build_shell(TINY, host="127.0.0.1", port=0, device="cpu").start()
    try:
        yield shell, run(TINY, device="cpu", log=lambda s: None)
    finally:
        shell.stop()


@pytest.mark.parametrize("binary", [True, False])
def test_tsunami_run_over_exported_pools(exported, binary, capsys):
    """``run(..., remote=...)`` against the exported pools, in both
    protocols: every key of the in-process run, a wire/service split per
    level, the series GP, and chains equal to the in-process chains (the
    same GP and solves answer, and chains do not depend on batching)."""
    shell, local = exported
    host, port = shell.address
    res = run(TINY, device="cpu", remote=(f"{host}:{port}",), remote_binary=binary, log=print)
    printed = capsys.readouterr().out
    assert set(res) == set(local)
    assert res["gp"] is None and not res["failures"]
    assert set(res["walls"]) == {"hierarchy_s", "connect_s", "sampling_s", "series_gp_s"}
    split = res["balancer"]["wire_split"]
    assert sorted(key.rsplit(":", 1)[1] for key in split) == ["level0", "level1", "level2"]
    assert "wire vs remote service" in printed and "reconstructed series" in printed
    assert np.array_equal(res["chains"], local["chains"])
    assert torch.equal(res["posterior_series"], local["posterior_series"])


def test_export_pools_keeps_the_asked_levels(exported):
    shell, local = exported
    servers = local_level_servers(TINY, local["gp"], local["hierarchy"])
    sub = export_pools(TINY, servers, n_obs=4, host=None, port=0, levels="1,2")
    assert sub.tags == ["level1", "level2"]
    assert shell.tags == ["level0", "level1", "level2"]


def test_remote_run_needs_a_reachable_endpoint():
    """A transport that cannot connect raises: nothing falls back to an
    in-process pool."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens on this port now
    w = dataclasses.replace(TINY, remote_retries=0, remote_timeout_s=2.0)
    with pytest.raises(TransportError):
        make_remote_level_servers(w, [f"127.0.0.1:{port}"])


def test_make_remote_level_servers_closes_each_transport_once(leak_check, monkeypatch):
    """One shared transport per endpoint: its replicas (one per exported
    tag) share it, and ``close_transports`` closes each transport once."""
    shells = [make_shell([BatchServer(_f, name=f"{tag}-{i}", capacity_tags=(tag,))
                          for tag in ("level0", "level1")], name=f"ep{i}")
              for i in range(2)]
    calls = []
    real = make_transport

    def dial(addr, **kw):
        assert kw["binary"] is False and kw["n_connections"] == TINY.remote_connections
        tr = real(shells[int(addr[-1])], **kw)
        close = tr.close
        tr.close = lambda: (calls.append(addr), close())[1]
        return tr

    monkeypatch.setattr("repro_torch.net.make_transport", dial)
    servers = make_remote_level_servers(TINY, ["ep0", "ep1"], binary=False)
    assert len(servers) == 4
    assert sorted(t for s in servers for t in s.capacity_tags) == [
        "level0", "level0", "level1", "level1"]
    assert len({id(s.transport) for s in servers}) == 2
    assert close_transports(servers) == 2
    assert sorted(calls) == ["ep0", "ep1"]
    for shell in shells:
        shell.stop()
