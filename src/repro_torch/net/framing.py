"""Binary wire framing: length-prefixed header + raw array bytes.

The paper's deployment shape (UM-Bridge) puts a network between the
balancer and the simulation servers; its JSON protocol is the interop
story, not the hot path — encoding a (B, 2048) fp32 batch as JSON costs
three orders of magnitude more CPU than the solve dispatch overhead the
O(1) engine left behind (``BENCH_dispatch.json``: 93 µs/request).  This
module is the fast mode: one frame is

    u32 header_len (LE) | header JSON | raw array payload bytes

where the header describes the op (``eval`` / ``eval_batch`` / ``info``),
the request id (pipelining: responses are matched by id, not order) and
one ``{dtype, shape}`` spec per payload array.  Array bytes cross the
wire exactly as they sit in memory (C-contiguous little-endian): the
sender hands ``socket.sendall`` a ``memoryview`` of the numpy buffer (no
serialisation, no copy) and the receiver ``recv_into``s a single
allocation that ``np.frombuffer`` reinterprets in place — the only copy
on either side is the kernel socket copy.  Mode negotiation is the first
eight bytes of a connection: clients that speak this protocol open with
``MAGIC``; anything else is treated as an HTTP request (the UM-Bridge
JSON mode) by :class:`repro_torch.net.server.ServerShell`.

Frames are written under the connection's write lock in one piece (small
frames coalesce into a single ``sendall``), so concurrent pipelined
callers never interleave bytes mid-frame.  See DESIGN.md §11.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"REPROB1\n"  # per-connection negotiation preamble (binary mode)
PROTOCOL_VERSION = 1
# Below this many payload bytes the whole frame goes out as ONE sendall
# (one syscall, one small copy); above it each array buffer is written
# zero-copy straight from its numpy memoryview.
SMALL_FRAME = 1 << 15

_HDR = struct.Struct("<I")

# Error channel: exceptions cross the wire as ["TypeName", "message"] and
# come back as the nearest local type (per-member scatter semantics of
# BatchServer.check_finite and friends survive the hop).
_ERROR_TYPES = {
    "FloatingPointError": FloatingPointError,
    "ValueError": ValueError,
    "TypeError": TypeError,
    "KeyError": KeyError,
    "RuntimeError": RuntimeError,
}


def encode_error(exc: BaseException) -> List[str]:
    return [type(exc).__name__, str(exc)]


def decode_error(pair: Sequence[str]) -> BaseException:
    name, msg = pair[0], pair[1]
    cls = _ERROR_TYPES.get(name)
    if cls is None:
        return RuntimeError(f"{name}: {msg}")
    return cls(msg)


def _wire_array(a: Any) -> np.ndarray:
    """Coerce to a C-contiguous little-endian ndarray (the wire layout)."""
    arr = np.ascontiguousarray(a)
    if arr.dtype.byteorder == ">":  # big-endian host arrays: swap once here
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr


def send_frame(
    sock: socket.socket, header: Dict[str, Any], arrays: Sequence[Any] = ()
) -> None:
    """Write one frame.  ``arrays`` payloads are appended after the JSON
    header with their specs recorded under ``header["arrays"]``."""
    wire = [_wire_array(a) for a in arrays]
    h = dict(header)
    h["arrays"] = [{"dtype": a.dtype.str, "shape": list(a.shape)} for a in wire]
    hb = json.dumps(h, separators=(",", ":")).encode()
    payload = sum(a.nbytes for a in wire)
    if payload <= SMALL_FRAME:
        buf = b"".join(
            [_HDR.pack(len(hb)), hb, *(memoryview(a).cast("B") for a in wire)]
        )
        sock.sendall(buf)
        return
    sock.sendall(_HDR.pack(len(hb)) + hb)
    for a in wire:
        sock.sendall(memoryview(a).cast("B"))  # zero-copy payload write


def _recv_into(sock: socket.socket, mv: memoryview) -> None:
    while len(mv):
        n = sock.recv_into(mv)
        if n == 0:
            raise ConnectionError("peer closed mid-frame")
        mv = mv[n:]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


def recv_frame(
    sock: socket.socket,
) -> Tuple[Optional[Dict[str, Any]], List[np.ndarray]]:
    """Read one frame; ``(None, [])`` on a clean close at a frame boundary.

    Payload arrays are materialised zero-copy: one ``bytearray``
    allocation per array, filled by ``recv_into`` and reinterpreted by
    ``np.frombuffer`` — never decoded, never copied again.
    """
    first = sock.recv(_HDR.size)
    if not first:
        return None, []
    while len(first) < _HDR.size:
        more = sock.recv(_HDR.size - len(first))
        if not more:
            raise ConnectionError("peer closed mid-frame")
        first += more
    (hlen,) = _HDR.unpack(first)
    header = json.loads(_recv_exact(sock, hlen))
    arrays: List[np.ndarray] = []
    for spec in header.get("arrays", ()):
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        buf = bytearray(nbytes)
        _recv_into(sock, memoryview(buf))
        arrays.append(np.frombuffer(buf, dtype=dt).reshape(shape))
    return header, arrays
