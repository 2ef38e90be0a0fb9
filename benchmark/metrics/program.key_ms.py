"""program.key_ms (ms): closed loop, the `program.key` span's self time a
search over the measured window: the program key built from every
searcher's attributes and the cache lookup, on every call. None where the
program counts no such span."""


def read(obs):
    c, n = obs["counters"], obs["searches"]
    if not n or not c.get("program.key.calls"):
        return None
    return c.get("program.key.self_us", 0) / 1e3 / n
