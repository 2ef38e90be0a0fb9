"""program.captures (captures): closed loop, the program's
SearchProgramCaptures counter's change across the measured window; a
capture there is a stall the tail shows."""


def read(obs):
    return obs["counters"].get("SearchProgramCaptures", 0)
