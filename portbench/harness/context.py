"""What a driver is handed: the cell, the run's arguments and where it may
write."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict

from .cells import ROOT, Cell


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: Path = ROOT
    # Settings a test passes to run a cell at a small size on the CPU; a
    # run of the benchmark passes none.
    overrides: Dict[str, Any] = field(default_factory=dict)
    # End a run that hangs, with every thread's stack (``portbench/run.py``).
    watchdog: bool = False

    @property
    def out_dir(self) -> Path:
        return self.root / "build" / "portbench"

    @property
    def config(self) -> Dict[str, Any]:
        return {**self.cell.config, **self.overrides.get("config", {})}

    @property
    def mix(self) -> Dict[str, Any]:
        return {**self.cell.mix, **self.overrides.get("mix", {})}

    def log(self, msg: str) -> None:
        print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
