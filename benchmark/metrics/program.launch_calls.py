"""program.launch_calls (calls): closed loop, the CUDA runtime and driver
calls that launch, copy or set in the traced window, a search (a replayed
program makes a handful; an eager body one a kernel)."""


def read(obs):
    t = obs["trace"]
    if not t or not t["searches"]:
        return None
    return t["launch_calls"] / t["searches"]
