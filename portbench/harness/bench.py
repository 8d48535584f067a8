"""The interface a driver's ``Bench`` keeps, with its defaults.

``Bench(ctx)`` sets the program up and warms every shape the cell uses;
``window()`` runs the measured window (on a thread of its own);
``end_to_end()`` gives the cell's end-to-end values by name; ``facts``
holds what the per-layer readers (``portbench/metrics``) read;
``device_trace()`` gives the traced slice of a ``--trace 1`` run (a
``portbench.harness.trace.Trace`` or the serving drivers' event spans), or
``None``; ``release()`` frees the program's state; ``verify()`` returns the
comparisons with the plain reference.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .report import Check


class BenchBase:
    attempted: int = 0
    failed: int = 0

    def __init__(self) -> None:
        self.facts: Dict[str, Any] = {}
        self.trace = None

    def device_trace(self):
        return self.trace

    def window(self) -> None:
        raise NotImplementedError

    def end_to_end(self) -> Dict[str, float]:
        return {}

    def release(self) -> None:
        pass

    def verify(self) -> List[Check]:
        raise NotImplementedError

    def extra(self) -> Dict[str, Any]:
        """Further keys of the result line (read by no check)."""
        return {}
