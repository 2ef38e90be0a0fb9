"""scan_roofline (%): the least time the exact scan's own work takes on
the card (benchmark/roofline.py: the stored rows read once, the queries
and the k results; 2 * batch * rows * dim operations) over the card's busy
time a search. It counts the work of the problem, not of the kernels that
do it, so a later change of kernels leaves the yardstick standing. Exact
closed-loop cells only."""

from benchmark.roofline import exact_scan_s


def read(obs):
    t, tr, cfg = obs["trace"], obs["traffic"], obs["config"]
    if tr.get("index") or not t or t["busy_s"] <= 0 or not t["searches"]:
        return None
    least = exact_scan_s(int(cfg["rows"]), int(cfg["dim"]), int(tr["batch"]), int(tr["k"]),
                         cfg["storage_dtype"])
    return 100.0 * least / (t["busy_s"] / t["searches"])
