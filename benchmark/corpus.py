"""The data and the query pool of a configuration, made from the seed.

A frozen copy of the repo's clustered Gaussian corpus (`chip_smoke.py:443`
`make_corpus`, itself `bench.py:127`): `centres` blob centres drawn as
`centre_scale` times a standard normal, each row a random centre plus unit
normal noise; a query is a corpus row plus `query_noise` times a standard
normal (`chip_smoke.py:848` `sift_path`). Unlike the original it draws on
the device, with one `torch.Generator` seeded by `--seed`, in blocks of
rows copied to one host array: the port's `Table.insert` takes host rows.
The same seed on the same kind of device gives the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 131_072


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(config, seed: int, device):
    """(rows f32[n, dim], query pool f32[queries, dim]) on the host."""
    spec = config["corpus"]
    n, d, nq = int(config["rows"]), int(config["dim"]), int(config["queries"])
    g = generator(seed, device)
    centres = float(spec["centre_scale"]) * torch.randn(
        int(spec["centres"]), d, generator=g, device=device)
    rows = np.empty((n, d), np.float32)
    for i in range(0, n, BLOCK_ROWS):
        m = min(BLOCK_ROWS, n - i)
        which = torch.randint(0, centres.shape[0], (m,), generator=g, device=device)
        x = centres[which] + torch.randn(m, d, generator=g, device=device)
        rows[i : i + m] = x.cpu().numpy()
    pick = torch.randperm(n, generator=g, device=device)[:nq].cpu().numpy()
    noise = torch.randn(nq, d, generator=g, device=device).cpu().numpy()
    queries = rows[pick] + float(spec["query_noise"]) * noise
    return rows, queries.astype(np.float32)
