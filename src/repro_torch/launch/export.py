"""Export the Tōhoku level pools over a socket (DESIGN.md §11).

The server half of the two-process deployment the paper runs (simulation
servers behind UM-Bridge, balancer in the sampling process): build the
workload's hierarchy, GP surrogate and level pools on the card, as
``launch/tsunami.py`` does in-process, wrap the pools in a
:class:`~repro_torch.net.server.ServerShell`, and serve until interrupted.
Both protocols share the port: this process is a UM-Bridge model server
(``GET /Info`` / ``POST /Evaluate``) and the binary-framing endpoint that
:class:`~repro_torch.net.client.BinaryTransport` dials.

Two-process walkthrough::

    # terminal 1: the simulation server
    PYTHONPATH=src python -m repro_torch.launch.export --workload cpu --port 4242

    # terminal 2: the balancer and sampler
    PYTHONPATH=src python -m repro_torch.launch.tsunami --workload cpu \\
        --remote 127.0.0.1:4242

``--device cpu`` runs the plain PyTorch versions of the kernels (both
processes take the flag).  Ctrl-C drains gracefully: the listener closes
first, in-flight evaluations finish and ship, then the worker pool and
every connection thread join.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Sequence

# The Tōhoku source location (x, y) in km: every level's input width.
THETA_DIM = 2


def export_pools(w, servers: Sequence, *, n_obs: int, host: str, port: int,
                 levels: str = "all"):
    """A :class:`~repro_torch.net.server.ServerShell` over level pools that
    are already built (``make_level_servers``), ready to ``start()``.

    ``levels`` restricts what is exported ("all", or a comma-separated
    subset like "1,2" to keep the GP local to the sampling process and farm
    out only the PDE solves).  Every tag takes ``THETA_DIM`` inputs and
    gives ``n_obs`` outputs.
    """
    from repro_torch.net import ServerShell

    if levels != "all":
        keep = {f"level{int(x)}" for x in levels.split(",")}
        servers = [s for s in servers if keep & set(s.capacity_tags or keep)]
    tags = sorted({t for s in servers for t in (s.capacity_tags or ())})
    return ServerShell(
        list(servers),
        host=host,
        port=port,
        name=f"tohoku-{w.name}",
        input_sizes={t: [THETA_DIM] for t in tags},
        output_sizes={t: [n_obs] for t in tags},
    )


def build_shell(w, *, host: str, port: int, levels: str = "all", device: str = "cuda"):
    """Hierarchy, GP, level servers and shell on ``device``, ready to
    ``start()``."""
    from repro_torch.device import resolve_device
    from repro_torch.swe import build_hierarchy, local_level_servers, train_level0_gp

    h = build_hierarchy(w, resolve_device(device))
    prob = h["problem"]
    gp = train_level0_gp(
        h["forward_coarse_batch"], prob, n_train=w.gp_train_points, steps=w.gp_opt_steps
    )
    servers = local_level_servers(w, gp, h)
    return export_pools(w, servers, n_obs=len(prob.y_obs), host=host, port=port,
                        levels=levels)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve the Tōhoku level pools over TCP "
        "(binary framing + UM-Bridge HTTP on one port)."
    )
    ap.add_argument("--workload", default="cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=4242)
    ap.add_argument(
        "--levels", default="all",
        help='exported levels: "all" or a subset like "1,2"',
    )
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.configs.tohoku_mlda import CONFIGS

    w = CONFIGS[args.workload]
    print(f"[export] building {w.name} hierarchy + GP "
          f"(coarse {w.coarse_grid}, fine {w.fine_grid}) on {args.device} ...", flush=True)
    t0 = time.time()
    shell = build_shell(w, host=args.host, port=args.port, levels=args.levels,
                        device=args.device)
    shell.start()
    host, port = shell.address
    print(f"[export] ready in {time.time() - t0:.1f}s — serving "
          f"{shell.tags} on {host}:{port} (Ctrl-C to drain and exit)", flush=True)
    try:
        # Serve until interrupted; the accept loop runs on its own thread.
        threading.Event().wait()
    except KeyboardInterrupt:
        print("\n[export] draining in-flight evaluations ...")
    finally:
        shell.stop(drain=True)
        print("[export] stopped.")


if __name__ == "__main__":
    main()
