"""Open-loop serving: requests arrive on a fixed schedule (Poisson gaps at
the mix's ``rate_rps``), whatever the engine's backlog, and each is timed
from when it was due.  How late the generator ran is reported beside the
metrics.  See ``portbench.harness.serving``."""
from portbench.harness.serving import ServeBench


class Bench(ServeBench):
    loop = "open"
