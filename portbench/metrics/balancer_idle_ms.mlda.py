"""Mean node idle time per request over the window's requests (ms): the
balancer's own Fig. 9 quantity (``LoadBalancer.summary()``), differenced at
the window's edges."""


def read(facts, trace):
    n = facts.get("idle_n", 0)
    return facts["idle_sum_s"] / n * 1e3 if n else None
