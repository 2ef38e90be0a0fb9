"""SQ8 scalar quantization on the device.

Counterpart of myscaledb_tpu/ops/quantize.py, the device-side SQ8 codec
only: per-dimension affine codes x ~= lo + code * scale with
scale = (hi - lo) / 255. The HNSW traversal shadow and the HNSWSQ payload
use it. `torch.round` rounds half to even, as `jnp.round` does, so both
packages give the same codes for the same f32 input. The PQ codec and the
host (numpy) variants wait for IVFPQ and the host tier (ROADMAP queue 1
#5, #9).
"""

from __future__ import annotations

from typing import Tuple

import torch


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
