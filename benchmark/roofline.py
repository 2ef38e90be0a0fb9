"""The least time the card could take for a piece of work.

A frozen copy of `chip_smoke.py:1128` `bound` and its peaks: one NVIDIA
H100 SXM's published dense rates (NVIDIA's data sheet, at the full 700 W):
3.35 TB/s of HBM, 989 TFLOP/s bf16, 495 TF32, 67 f32 outside the tensor
cores.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
STORED_BYTES = {"bfloat16": 2, "float32": 4}
SCORE_KIND = {"bfloat16": "bf16", "float32": "tf32"}


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    """max(bytes / peak bytes/s, operations / peak operations/s)."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def exact_scan_s(rows: int, dim: int, batch: int, k: int, storage_dtype: str) -> float:
    """The exact scan's own work for one batch, whichever kernels do it:
    the stored rows read once, the f32 queries read and k (distance, id)
    pairs written per query; 2 * batch * rows * dim operations in the
    stored type's tensor-core rate."""
    nbytes = rows * dim * STORED_BYTES[storage_dtype] + batch * dim * 4 + batch * k * 8
    return bound_s(nbytes, 2.0 * batch * rows * dim, SCORE_KIND[storage_dtype])
