"""Fine samples of all chains a second over the window (samples/s): the
rate the host-bound ``mlda-paper`` cell runs at, read in its traced runs
(the profiler's start, stop and parse are left out of the window; the
traced round is in it)."""


def read(facts, trace):
    if facts.get("window_s", 0) <= 0 or not facts.get("fine_samples"):
        return None
    return facts["fine_samples"] / facts["window_s"]
