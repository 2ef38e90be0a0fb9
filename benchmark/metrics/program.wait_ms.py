"""program.wait_ms (ms): closed loop, the `result.readback` span's self time
a search over the measured window: the host waiting for the card and the
answer's copy back. None where the program counts no such span."""


def read(obs):
    c, n = obs["counters"], obs["searches"]
    if not n or not c.get("result.readback.calls"):
        return None
    return c.get("result.readback.self_us", 0) / 1e3 / n
