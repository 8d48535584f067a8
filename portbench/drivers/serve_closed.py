"""Closed-loop serving: ``clients`` callers, each submitting its next
request the moment its last one finished, so a freed slot refills at once.
See ``portbench.harness.serving``."""
from portbench.harness.serving import ServeBench


class Bench(ServeBench):
    loop = "closed"
