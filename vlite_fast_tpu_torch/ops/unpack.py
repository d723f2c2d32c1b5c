"""Sample unpacking: raw digitizer bytes -> float voltages.

Port of vlite_fast_tpu/ops/unpack.py (ref convertarray,
src/pb_kernels.cu:23-33): u -> u/128 - 1, except that a 0 byte (the
capture gap-filler's flag value) stays 0.
"""

from __future__ import annotations

import torch


def convert_uint8(u: torch.Tensor) -> torch.Tensor:
    """uint8 offset-binary -> float32 voltage; 0 maps to 0 (gap fill)."""
    f = u.to(torch.float32) * (1.0 / 128.0) - 1.0
    return torch.where(u == 0, torch.zeros_like(f), f)
