"""Share of the positions fed through prefill chunks over the window that
are padding (%): the program's tallies ``prefill pad tokens`` over ``prefill
tokens`` plus ``prefill pad tokens``, differenced at the window's edges
(``facts["tallies"]``).  A prompt's last, partial chunk is padded to the
next power of two from 16, so this is the prefill work that buys only a
bounded set of chunk graphs.  Nothing where the window ran no chunk."""


def read(facts, trace):
    t = facts.get("tallies", {})
    pad = t.get("prefill pad tokens", 0)
    fed = t.get("prefill tokens", 0) + pad
    return 100.0 * pad / fed if fed > 0 else None
