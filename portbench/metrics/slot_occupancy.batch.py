"""Mean share of the paged pool's slots in use per decode step over the
window (%): the balancer summary's slot occupancy, differenced at the
window's edges."""


def read(facts, trace):
    share = facts.get("slot_share")
    return None if share is None else 100.0 * share
