"""ivf.gathered_rows (rows): closed loop, the rows the IVF window step
gathered and scored a query over the measured window: the program's
`ivf.window_rows` profile event (padded queries * windows * 512, padding
and repeated windows included) over the queries answered. None where the
program counts no such event."""


def read(obs):
    c, n = obs["counters"], obs["queries"]
    if not n or not c.get("ivf.window_rows"):
        return None
    return c["ivf.window_rows"] / n
