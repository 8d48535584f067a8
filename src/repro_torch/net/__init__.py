"""Network-transparent serving: UM-Bridge-style remote servers (DESIGN.md §11).

The paper fronts its simulation servers with a language-agnostic network
interface (UM-Bridge); this package is that boundary for our balancer:

* :mod:`repro_torch.net.framing` — the binary wire format (length-prefixed JSON
  header + raw little-endian array bytes, zero-copy through numpy);
* :mod:`repro_torch.net.server`  — :class:`ServerShell`, which exports any
  existing :class:`~repro_torch.balancer.types.Server` /
  :class:`~repro_torch.balancer.types.BatchServer` pool over a socket and
  speaks binary framing *and* UM-Bridge HTTP/JSON on one port;
* :mod:`repro_torch.net.client`  — pipelined pooled transports
  (:class:`BinaryTransport` / :class:`JSONTransport`) and the
  :class:`RemoteServer` / :class:`RemoteBatchServer` types the dispatcher
  schedules like any local server, with transport faults feeding its
  server-death/requeue path and telemetry splitting wire time from
  remote service time.

``launch/export.py`` is the server-side CLI; ``launch/tsunami.py``'s ``--remote``
flag is the client side of the two-process walkthrough.
"""
from .client import (
    BinaryTransport,
    JSONTransport,
    RemoteBatchServer,
    RemoteServer,
    TransportError,
    make_transport,
    parse_address,
    remote_servers_for,
    tcp_dialer,
)
from .framing import MAGIC, PROTOCOL_VERSION, recv_frame, send_frame
from .server import ServerShell, export_servers

__all__ = [
    "BinaryTransport",
    "JSONTransport",
    "MAGIC",
    "PROTOCOL_VERSION",
    "RemoteBatchServer",
    "RemoteServer",
    "ServerShell",
    "TransportError",
    "export_servers",
    "make_transport",
    "parse_address",
    "recv_frame",
    "remote_servers_for",
    "send_frame",
    "tcp_dialer",
]
