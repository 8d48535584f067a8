"""Share of the window in which the level-2 (fine) servers are busy (%) in
``mlda-paper``, read as ``fine_pool_busy.mlda`` reads it in
``mlda-paper-device``: the same quantity under a name of its own, since
the two cells report different end-to-end metrics."""
from pathlib import Path

from portbench.harness.cells import load_file

_SAME = load_file(Path(__file__).with_name("fine_pool_busy.mlda.py"), "metrics")


def read(facts, trace):
    return _SAME.read(facts, trace)
