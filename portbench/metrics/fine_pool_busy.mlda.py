"""Share of the window in which the level-2 (fine) servers are busy (%):
their ``per_server_uptime`` differenced at the window's edges, over the
servers' count times the window."""


def read(facts, trace):
    n = facts.get("n_fine_servers", 0)
    if not n or facts.get("window_s", 0) <= 0:
        return None
    return 100.0 * facts["fine_busy_s"] / (n * facts["window_s"])
