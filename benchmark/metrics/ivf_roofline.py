"""ivf_roofline (%): the least time an IVF search's own work takes on the
card (benchmark/roofline_ivf.py: the probed lists' codes read once, the
re-ranked rows, the queries, the results and the centroids; the centroid
ranking and 2 * D a scored row at the f32 rate) over the card's busy time
a search. Index cells only; None where the index kind is not sized. An
index spec without `rerank_multiple` takes the port's default, 4."""

from benchmark.roofline_ivf import search_s


def read(obs):
    t, tr, cfg = obs["trace"], obs["traffic"], obs["config"]
    if not tr.get("index") or not t or t["busy_s"] <= 0 or not t["searches"]:
        return None
    spec = cfg["indexes"][tr["index"]]
    least = search_s(int(cfg["rows"]), int(cfg["dim"]), int(tr["batch"]), int(tr["k"]),
                     cfg["storage_dtype"], spec["type"], int(spec["ncentroids"]),
                     int(tr["params"]["nprobe"]),
                     rerank_multiple=int(spec.get("rerank_multiple", 4)))
    if least is None:
        return None
    return 100.0 * least / (t["busy_s"] / t["searches"])
