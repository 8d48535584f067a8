"""The run's result line, the comparisons beside their limits, and the
check that nothing of JAX or the JAX package was loaded."""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

# Top-level module names a run must never load: JAX, its libraries, and the
# JAX package the port was made from.  Compared whole: ``repro_torch`` is
# not ``repro``.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclass
class Check:
    """One number compared with the reference, and its limit: the check
    passes when ``value <= limit`` (and the value is a number)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def checks_ok(checks: List[Check]) -> bool:
    return bool(checks) and all(c.ok for c in checks)


def result_line(*, correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict[str, Any]],
                device: Dict[str, Any], checks: List[Check],
                breakdown: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """The result line's JSON object, the comparisons under ``checks`` last."""
    out: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    for k, v in (extra or {}).items():
        out[k] = v
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)


def print_checks(checks: List[Check], stream=sys.stderr) -> None:
    for c in checks:
        print(f"[portbench] check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=stream, flush=True)
