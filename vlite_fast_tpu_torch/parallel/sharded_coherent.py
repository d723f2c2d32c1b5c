"""Time-sharded coherent dedispersion with halo exchange.

Port of vlite_fast_tpu/parallel/sharded_coherent.py on the port's
ops/coherent (torch.fft, complex64).  The offline coherent-dedispersion
step has a receptive field of the DM smearing time: sample t of the
output needs raw voltages from [t - n_hi, t + n_lo].  On an (ant, time)
mesh the voltage stream is sharded over 'time', so each shard pulls
trailing samples from its previous neighbor and leading samples from its
next (parallel/halo), runs the chirp on the extended block, and keeps its
own span: the overlap-save pattern of genbase (ref
src/genbase.cu:366-390) turned into the mesh's sequence parallelism
(SURVEY.md section 5).
"""

from __future__ import annotations

import torch

from vlite_fast_tpu_torch.ops import coherent as coh
from vlite_fast_tpu_torch.parallel.halo import halo_from_next, halo_from_prev


def sharded_halo(dm: float, sample_rate: float, bandwidth_mhz: float = 64.0,
                 freq_bot_mhz: float = 320.0) -> int:
    """The halo each side of a shard: the full smearing span plus margin
    for the chirp's impulse-response tails beyond the nominal group-delay
    support (measured ~5% error at exact-halo block edges)."""
    n_lo, n_hi = coh.smearing_samples(dm, sample_rate, freq_bot_mhz,
                                      freq_bot_mhz + bandwidth_mhz / 2,
                                      freq_bot_mhz + bandwidth_mhz)
    return int((n_lo + n_hi) * 1.0 + 4096)


def coherent_dedisperse_sharded(x_local: torch.Tensor, mesh, dm: float,
                                sample_rate: float,
                                bandwidth_mhz: float = 64.0,
                                freq_bot_mhz: float = 320.0) -> torch.Tensor:
    """x_local: this rank's (npol, local) time shard of the voltages ->
    its dedispersed (npol, local) span, the central (valid) region of an
    overlap-save block of local + 2 * halo samples.  Collective over the
    mesh's 'time' axis."""
    halo = sharded_halo(dm, sample_rate, bandwidth_mhz, freq_bot_mhz)
    local = x_local.shape[1]
    if halo >= local:
        raise ValueError(f"shard span {local} smaller than the DM smearing "
                         f"halo {halo}; use fewer time shards")
    # [prev tail, x_local, next head]: the next shard's head from its own
    # block, taken before any past halo is prepended to it (the JAX
    # package appends the head of the next shard's extended block, which
    # is this shard's own tail)
    future = halo_from_next(x_local, halo, mesh, dim=1)[:, local:]
    block = torch.cat([halo_from_prev(x_local, halo, mesh, dim=1), future],
                      dim=1)
    ker = torch.conj(coh.dispersion_kernel(block.shape[1], dm, bandwidth_mhz,
                                           freq_bot_mhz, taper=False,
                                           device=block.device))
    out = coh.apply_chirp(block, ker)
    return out[:, halo:halo + local]
