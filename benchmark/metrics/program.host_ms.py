"""program.host_ms (ms): closed loop, the program's host time a search over
the measured window: the self time of the `program.run` span (the device
lock, the stream bookkeeping, the graph launch, the output's copy) and of
`program.load` (the staging wait, the pinned fill, the upload). None where
the program counts no such span."""

SPANS = ("program.run", "program.load")


def read(obs):
    c, n = obs["counters"], obs["searches"]
    if not n or not c.get("program.run.calls"):
        return None
    return sum(c.get(f"{s}.self_us", 0) for s in SPANS) / 1e3 / n
