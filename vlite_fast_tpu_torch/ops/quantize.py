"""Output re-quantization: channel trim + 2/4/8-bit digitize + byte packing.

Port of vlite_fast_tpu/ops/quantize.py (ref sel_and_dig_2b/4b/8b,
src/pb_kernels.cu:633-735).  Packing is byte-identical to the JAX
package: within a byte earlier samples take the lower bits; bytes are
time-major, then pol, then channel.
"""

from __future__ import annotations

import torch

from vlite_fast_tpu import constants as C

# One packed byte whose every sample slot holds the quantizer's
# near-zero level: the pad fill for ragged search gulps.
NEAR_ZERO_FILL = {2: 0x55, 4: 0x77, 8: 0x7F}

_LEVEL2_CENTROIDS = (-1.24, -0.098, 0.85, 1.94)  # unit-normal bin centroids


def quantize_2bit(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 levels {0,1,2,3}."""
    t0, t1, t2 = C.QUANT2_THRESH
    return ((x >= t0).to(torch.uint8) + (x >= t1).to(torch.uint8)
            + (x >= t2).to(torch.uint8))


def quantize_4bit(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 levels {0..15}: clip(x/0.3188 + 7.5, 0, 15)."""
    tmp = x * torch.tensor(1.0 / C.QUANT4_SCALE, dtype=torch.float32) \
        + C.QUANT4_OFFSET
    return torch.clamp(tmp, 0.0, 15.0).to(torch.uint8)


def quantize_8bit(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8: clip(x/0.02957 + 127.5, 0, 255)."""
    tmp = x * torch.tensor(1.0 / C.QUANT8_SCALE, dtype=torch.float32) \
        + C.QUANT8_OFFSET
    return torch.clamp(tmp, 0.0, 255.0).to(torch.uint8)


def pack_bits(levels: torch.Tensor, nbit: int) -> torch.Tensor:
    """Pack uint8 levels along the last axis, LSB-first.
    (..., n) -> (..., n*nbit//8) uint8."""
    if nbit == 8:
        return levels
    per_byte = 8 // nbit
    g = levels.reshape(*levels.shape[:-1], levels.shape[-1] // per_byte,
                       per_byte).to(torch.int32)
    shifts = torch.arange(per_byte, dtype=torch.int32,
                          device=levels.device) * nbit
    return (g << shifts).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, nbit: int) -> torch.Tensor:
    """Inverse of pack_bits."""
    if nbit == 8:
        return packed
    per_byte = 8 // nbit
    shifts = torch.arange(per_byte, dtype=torch.int32,
                          device=packed.device) * nbit
    out = (packed.to(torch.int32)[..., None] >> shifts) & ((1 << nbit) - 1)
    return out.to(torch.uint8).reshape(*packed.shape[:-1],
                                       packed.shape[-1] * per_byte)


def dequantize(packed: torch.Tensor, nbit: int) -> torch.Tensor:
    """Packed filterbank bytes -> float32 values recentered to ~N(0,1).
    (..., nbytes) -> (..., nbytes * 8//nbit)."""
    lev = unpack_bits(packed, nbit)
    if nbit == 2:
        cent = torch.tensor(_LEVEL2_CENTROIDS, dtype=torch.float32,
                            device=packed.device)
        return cent[lev.to(torch.int64)]
    lev = lev.to(torch.float32)
    if nbit == 4:
        return (lev - C.QUANT4_OFFSET) * torch.tensor(C.QUANT4_SCALE,
                                                      dtype=torch.float32)
    return (lev - C.QUANT8_OFFSET) * torch.tensor(C.QUANT8_SCALE,
                                                  dtype=torch.float32)


def sel_and_dig(x: torch.Tensor, chanmin: int, chanmax: int,
                nbit: int) -> torch.Tensor:
    """Channel trim + quantize + pack.

    x: (npol, ntime, nchan) -> packed uint8 (ntime, npol*nchanout*nbit//8),
    time-major with pol then channel fastest."""
    trimmed = x[:, :, chanmin:chanmax + 1]
    if nbit == 2:
        lev = quantize_2bit(trimmed)
    elif nbit == 4:
        lev = quantize_4bit(trimmed)
    elif nbit == 8:
        lev = quantize_8bit(trimmed)
    else:
        raise ValueError(f"unsupported nbit {nbit}")
    npol, ntime, nchanout = lev.shape
    lev = lev.transpose(0, 1).reshape(ntime, npol * nchanout)
    return pack_bits(lev, nbit)
