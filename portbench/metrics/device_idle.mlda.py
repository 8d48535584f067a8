"""Share of the traced slice with nothing running on the card (%)."""
from portbench.metrics_common import idle_share


def read(facts, trace):
    return idle_share(trace)
