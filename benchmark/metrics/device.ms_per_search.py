"""device.ms_per_search (ms): closed loop, the card's busy time in the
traced window (the union of its kernels, memcpys and memsets) over the
searches there."""


def read(obs):
    t = obs["trace"]
    if not t or t["busy_s"] <= 0 or not t["searches"]:
        return None
    return 1e3 * t["busy_s"] / t["searches"]
