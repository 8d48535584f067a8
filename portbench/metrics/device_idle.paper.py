"""Share of the traced slice with nothing running on the card (%) in
``mlda-paper``, read as ``device_idle.mlda`` reads it in
``mlda-paper-device``: the same quantity under a name of its own, since
the two cells report different end-to-end metrics."""
from pathlib import Path

from portbench.harness.cells import load_file

_SAME = load_file(Path(__file__).with_name("device_idle.mlda.py"), "metrics")


def read(facts, trace):
    return _SAME.read(facts, trace)
