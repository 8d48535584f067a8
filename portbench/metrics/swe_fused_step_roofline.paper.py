"""The fused SWE step's share of its roofline in the traced slice (%) in
``mlda-paper``, read as ``swe_fused_step_roofline`` reads it in
``mlda-paper-device``: the same quantity under a name of its own, since
the two cells report different end-to-end metrics."""
from pathlib import Path

from portbench.harness.cells import load_file

_SAME = load_file(Path(__file__).with_name("swe_fused_step_roofline.py"), "metrics")


def read(facts, trace):
    return _SAME.read(facts, trace)
