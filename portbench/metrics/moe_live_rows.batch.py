"""Share of the expert rows the MoE layers computed over the window that
hold a routed (token, expert) pair (%): the program's tallies ``moe_pairs
routed`` over ``moe_rows computed``, differenced at the window's edges
(``facts["tallies"]``).  A row that holds no pair is capacity padding, the
work a kernel over live rows only would skip.  Nothing where the window
ran no MoE layer."""


def read(facts, trace):
    t = facts.get("tallies", {})
    rows = t.get("moe_rows computed", 0)
    return 100.0 * t.get("moe_pairs routed", 0) / rows if rows > 0 else None
