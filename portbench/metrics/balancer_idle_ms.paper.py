"""Mean node idle time per request over the window's requests (ms) in
``mlda-paper``, read as ``balancer_idle_ms.mlda`` reads it in
``mlda-paper-device``: the same quantity under a name of its own, since
the two cells report different end-to-end metrics."""
from pathlib import Path

from portbench.harness.cells import load_file

_SAME = load_file(Path(__file__).with_name("balancer_idle_ms.mlda.py"), "metrics")


def read(facts, trace):
    return _SAME.read(facts, trace)
