"""filter.mask_ms (ms): closed loop, the `filter.mask` span's self time a
search over the measured window: each segment's pre-filter outside the
program (its bitmap, the selectivity that routes it, and an IVF index's
layout of the passing rows or window mask), looked up, or built at a
filter's first search. None where the program counts no such span."""


def read(obs):
    c, n = obs["counters"], obs["searches"]
    if not n or not c.get("filter.mask.calls"):
        return None
    return c.get("filter.mask.self_us", 0) / 1e3 / n
