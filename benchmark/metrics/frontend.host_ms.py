"""frontend.host_ms (ms): closed loop, the front end's self time a search
over the measured window: the `table.search` span (validation, settings,
the query log) and the `table.gather` span (the id lookup on the host),
from their `<span>.self_us` profile events. None where the program counts
no such span."""


def read(obs):
    c, n = obs["counters"], obs["searches"]
    if not n or not c.get("table.search.calls"):
        return None
    return (c.get("table.search.self_us", 0) + c.get("table.gather.self_us", 0)) / 1e3 / n
