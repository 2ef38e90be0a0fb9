"""device.idle_share (%): closed loop, the share of the traced window in
which no kernel, memcpy or memset ran on the card."""


def read(obs):
    t = obs["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
