"""SQ8 and PQ codecs on the device.

Counterpart of myscaledb_tpu/ops/quantize.py, the device-side codecs:

  * SQ8: per-dimension affine codes x ~= lo + code * scale with
    scale = (hi - lo) / 255. The HNSW traversal shadow, HNSWSQ, IVFSQ and
    MSTG use it. `torch.round` rounds half to even, as `jnp.round` does,
    so both packages give the same codes for the same f32 input.
  * PQ: M subspaces of D/M dimensions, 2^bits centroids each (one
    `kmeans_fit` per subspace), 8-bit codes. Scoring decodes the codes to
    bf16 rows and takes the ordinary dot product (decode-then-dot), as in
    the JAX package. IVFPQ and HNSWPQ use it.

The `*_host` variants train on a host-tier corpus (ops/stream.py::
HostRep), whose rows stream through the device in chunks; their results
equal the JAX package's numpy `sq8_train` / `pq_train` on the same rows
(min and max are exact whatever the order, and PQ trains each subspace on
all of the rows, as there). Encoding a host corpus is done per chunk on
the device with the `*_dev` encoders: `round((x - lo) / scale)` in f32,
half to even, is the same in numpy and torch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import kmeans


def sq8_train_dev(rep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension (lo, scale) f32[D] of a [N, D] representation, on its
    device; a constant dimension gets scale 1."""
    lo = torch.amin(rep, dim=0).to(torch.float32)
    hi = torch.amax(rep, dim=0).to(torch.float32)
    scale = (hi - lo) / 255.0
    return lo, torch.where(scale > 0, scale, torch.ones_like(scale))


def sq8_encode_dev(rep: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """uint8[..., D] codes: round((x - lo) / scale), clipped to [0, 255]."""
    q = torch.round((rep - lo) / scale)
    return torch.clamp(q, 0, 255).to(torch.uint8)


def sq8_decode_dev(codes: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """uint8[..., D] -> bf16[..., D] decoded values."""
    return (codes.to(torch.float32) * scale + lo).to(torch.bfloat16)


def _pq_fit(subspace, n: int, m: int, ds: int, bits: int, n_iters: int, seed: int, init_idx):
    """Codebooks f32[M, 2^bits, ds]: subspace j (`subspace(j)`, f32[n, ds])
    is `kmeans_fit` with seed `seed + j` (or the initial rows
    `init_idx[j]`). With fewer rows than 2^bits, each subspace fits n
    centroids and repeats its last one."""
    ksub = 1 << bits
    ksub_eff = min(ksub, n)
    books = []
    for j in range(m):
        c = kmeans.kmeans_fit(
            subspace(j), n_clusters=ksub_eff, n_iters=n_iters,
            seed=seed + j, init_idx=None if init_idx is None else init_idx[j],
        )
        if ksub_eff < ksub:
            c = torch.cat([c, c[-1:].expand(ksub - ksub_eff, ds)], dim=0)
        books.append(c)
    return torch.stack(books, dim=0)


def pq_train_dev(
    rep: torch.Tensor,
    m: int,
    *,
    bits: int = 8,
    n_iters: int = 12,
    seed: int = 0,
    init_idx: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Codebooks f32[M, 2^bits, D/M] of a [N, D] representation on its
    device (`_pq_fit`)."""
    n, d = rep.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    ds = d // m
    return _pq_fit(lambda j: rep[:, j * ds : (j + 1) * ds], n, m, ds, bits, n_iters, seed, init_idx)


def pq_encode_dev(rep: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """uint8[N, M] codes: the nearest codeword of each subspace."""
    m, _, ds = codebooks.shape
    cols = [
        kmeans.assign_chunked(rep[:, j * ds : (j + 1) * ds], codebooks[j]) for j in range(m)
    ]
    return torch.stack(cols, dim=1).to(torch.uint8)


def pq_codeword_sqnorms(codebooks: torch.Tensor) -> torch.Tensor:
    """|decoded codeword|^2 per (subspace, code), f32[M, K], of the
    bf16-rounded codewords that `pq_decode_dev` returns, so L2 scores stay
    exact with respect to the codes."""
    cb = codebooks.to(torch.bfloat16).to(torch.float32)
    return torch.sum(cb * cb, dim=-1)


def pq_decoded_sqnorms(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """|decoded row|^2, f32[N], of uint8[N, M] codes: the sum of their
    codewords' `pq_codeword_sqnorms`."""
    cbn = pq_codeword_sqnorms(codebooks)  # [M, K]
    return torch.sum(torch.gather(cbn.T, 0, codes.to(torch.int64)), dim=1)


def pq_decode_dev(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """uint8[..., M] + f32[M, K, ds] -> bf16[..., M*ds] decoded rows."""
    m, _, ds = codebooks.shape
    sub = torch.arange(m, device=codes.device)
    dec = codebooks[sub, codes.to(torch.int64)]  # [..., M, ds]
    return dec.reshape(*codes.shape[:-1], m * ds).to(torch.bfloat16)


def sq8_train_host(rep, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sq8_train_dev` of a host-tier corpus (`HostRep`): per-dimension
    (lo, scale) f32[D] on `device`, the min and max folded over chunks."""
    lo = hi = None
    for _, _, x in rep.chunks(device):
        clo, chi = torch.amin(x, dim=0), torch.amax(x, dim=0)
        lo = clo if lo is None else torch.minimum(lo, clo)
        hi = chi if hi is None else torch.maximum(hi, chi)
    scale = (hi - lo) / 255.0
    return lo, torch.where(scale > 0, scale, torch.ones_like(scale))


def pq_train_host(
    rep,
    m: int,
    dim: int,
    device,
    *,
    bits: int = 8,
    n_iters: int = 12,
    seed: int = 0,
    init_idx: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Codebooks of a host-tier corpus's first `dim` columns (`_pq_fit`):
    each subspace is gathered on `device` from every row, one pass over
    the corpus per subspace."""
    if dim % m:
        raise ValueError(f"dim {dim} not divisible by M={m}")
    ds = dim // m

    def subspace(j):
        sub = torch.empty((rep.n, ds), dtype=torch.float32, device=device)
        for i, r, x in rep.chunks(device):
            sub[i : i + r] = x[:, j * ds : (j + 1) * ds]
        return sub

    return _pq_fit(subspace, rep.n, m, ds, bits, n_iters, seed, init_idx)
