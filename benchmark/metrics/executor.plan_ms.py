"""executor.plan_ms (ms): closed loop, the `vector_search` span's self time
a search over the measured window: the executor's query batch, segment
loop, masks and routing, less the program's spans. None where the program
counts no such span."""


def read(obs):
    c, n = obs["counters"], obs["searches"]
    if not n or not c.get("vector_search.calls"):
        return None
    return c.get("vector_search.self_us", 0) / 1e3 / n
