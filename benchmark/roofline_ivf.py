"""The least time the card could take for an IVF search's own work.

The work is the problem's, read from the configuration and the traffic,
not from the kernels that do it, so a later change of kernels leaves the
yardstick standing. An index asked for `ncentroids` lists builds
`n_lists` of them: the port's balanced k-means splits half as many again
off the heaviest lists (`EXTRA_LISTS`), so nprobe lists hold
rows * nprobe / n_lists rows on average. A query reads those rows' codes
once (IVFFLAT: rows of the stored type; IVFSQ and MSTG: SQ8 codes, one
byte a coordinate), and a two-stage index also its k * rerank_multiple
re-ranked rows of the stored type; the query comes in as f32 and k
(distance, id) pairs go out. A batch reads the n_lists f32 centroids
once. The operations are the centroid ranking, 2 * Q * n_lists * D, and
2 * D a probed or re-ranked row, at the f32 rate: the port scores IVF rows
in f32. Peaks from `benchmark/roofline.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

from benchmark.roofline import STORED_BYTES, bound_s

SQ8_KINDS = ("IVFSQ", "MSTG")  # two-stage: SQ8 codes, then the exact re-rank
# lists split off the heaviest ones a list asked for (the port's
# balanced k-means, `extra_frac`), for 4 lists asked or more
EXTRA_LISTS = 0.5


def n_lists(rows: int, ncentroids: int) -> int:
    """The lists an IVF index over `rows` rows builds for `ncentroids`."""
    c = max(1, min(ncentroids, rows))
    return c + (int(c * EXTRA_LISTS) if c >= 4 else 0)


def search_work(rows: int, dim: int, batch: int, k: int, storage_dtype: str, kind: str,
                ncentroids: int, nprobe: int,
                rerank_multiple: int) -> Optional[Tuple[float, float]]:
    """(bytes, operations) of one batch's IVF search; None for an index
    kind whose codes this does not size (IVFPQ)."""
    stored = STORED_BYTES[storage_dtype]
    if kind == "IVFFLAT":
        code, reranked = stored, 0
    elif kind in SQ8_KINDS:
        code, reranked = 1, k * rerank_multiple
    else:
        return None
    lists = n_lists(rows, ncentroids)
    probed = rows * min(nprobe, lists) / lists
    per_query = probed * dim * code + reranked * dim * stored + dim * 4 + k * 8
    nbytes = batch * per_query + lists * dim * 4
    flops = 2.0 * batch * lists * dim + 2.0 * dim * batch * (probed + reranked)
    return nbytes, flops


def search_s(*args, **kw) -> Optional[float]:
    """The least seconds of `search_work`'s batch on the card."""
    work = search_work(*args, **kw)
    return None if work is None else bound_s(work[0], work[1], "f32")
