"""p95_ms (ms): closed loop, the 95th percentile over every call in the
window, each timed from the call until its ids are on the host; linear
interpolation between order statistics (numpy's default, the same as
`statistics.quantiles(method="inclusive")`)."""

import numpy as np


def read(obs):
    if len(obs["latencies_s"]) == 0:
        return None
    return 1e3 * float(np.percentile(obs["latencies_s"], 95))
