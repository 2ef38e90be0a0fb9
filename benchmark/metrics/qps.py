"""qps (queries/s): closed loop, every query answered in the window over
the window's length."""


def read(obs):
    if not obs["window_s"]:
        return None
    return obs["queries"] / obs["window_s"]
