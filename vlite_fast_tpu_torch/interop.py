"""State carried across from the JAX package, as numpy arrays.

The tests start both packages from the same state: a JAX DSPState or
DedispPlan is read out as numpy (np.asarray on each field) and rebuilt
here as the port's tensors on a given device.  Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from vlite_fast_tpu_torch import devices
from vlite_fast_tpu_torch.models.baseband_dsp import DSPState
from vlite_fast_tpu_torch.ops import channelize as ch_ops
from vlite_fast_tpu_torch.ops.dedisperse import DedispPlan, batch_sub_spread


def state_from_jax(bp, bp_kur, segs_since_inject, tail, wtail,
                   device="cuda") -> DSPState:
    """The port's DSPState from the numpy fields of a JAX DSPState."""
    device = devices.resolve(device)
    t = lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32, copy=True)).to(device)
    return DSPState(bp=t(bp), bp_kur=t(bp_kur),
                    segs_since_inject=int(np.asarray(segs_since_inject)),
                    tail=t(tail), wtail=t(wtail))


def state_to_numpy(state: DSPState) -> dict:
    """The port's DSPState as numpy, keyed by the JAX DSPState's fields."""
    return {"bp": state.bp.cpu().numpy(), "bp_kur": state.bp_kur.cpu().numpy(),
            "segs_since_inject": np.int32(state.segs_since_inject),
            "tail": state.tail.cpu().numpy(),
            "wtail": state.wtail.cpu().numpy()}


def plan_from_jax(plan, device="cuda") -> DedispPlan:
    """The port's DedispPlan from a JAX DedispPlan's tables (read with
    np.asarray) and static scalars."""
    device = devices.resolve(device)
    t = lambda a, dt: torch.from_numpy(
        np.array(a, dtype=dt, copy=True)).to(device)
    sub_d = np.asarray(plan.sub_delays, np.int32)
    return DedispPlan(
        rel_delays=t(plan.rel_delays, np.int32),
        sub_delays=t(sub_d, np.int32),
        batch_of_dm=t(plan.batch_of_dm, np.int32),
        chan_weights=t(plan.chan_weights, np.float32),
        dms=tuple(float(d) for d in plan.dms),
        max_delay=int(plan.max_delay), max_sub_delay=int(plan.max_sub_delay),
        nsub=int(plan.nsub), nchan_eff=float(plan.nchan_eff),
        rel_delays_max=int(plan.rel_delays_max),
        rel_delays_min=int(np.asarray(plan.rel_delays).min()),
        sub_spread=batch_sub_spread(sub_d, np.asarray(plan.batch_of_dm),
                                    np.asarray(plan.rel_delays).shape[0]))


def bp_from_factored(bp_fact, nfft: int, nchan: int) -> np.ndarray:
    """The linear (npol, nchan) bandpass from the JAX package's factored
    (npol, 64, 128) stage-B plane (its megakernel.bp_from_factored, in
    numpy): plane entry (k2, k1) is channel k = k1 + n1 * k2."""
    n1, _ = ch_ops._ct_split(nfft)
    n2o = nfft // 2 // n1 + 1
    f = np.asarray(bp_fact, dtype=np.float32)
    return np.ascontiguousarray(
        f[:, :n2o, :n1].reshape(f.shape[0], -1)[:, :nchan])
