"""State carried across from the JAX package, as numpy arrays.

The tests start both packages from the same state: a JAX DSPState or
DedispPlan is read out as numpy (np.asarray on each field) and rebuilt
here as the port's tensors on a given device.  Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from vlite_fast_tpu_torch.models.baseband_dsp import DSPState
from vlite_fast_tpu_torch.ops.dedisperse import DedispPlan


def state_from_jax(bp, bp_kur, segs_since_inject, tail, wtail,
                   device="cpu") -> DSPState:
    """The port's DSPState from the numpy fields of a JAX DSPState."""
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


def plan_from_jax(plan, device="cpu") -> DedispPlan:
    """The port's DedispPlan from a JAX DedispPlan's tables (read with
    np.asarray) and static scalars."""
    t = lambda a, dt: torch.from_numpy(
        np.array(a, dtype=dt, copy=True)).to(device)
    return DedispPlan(
        rel_delays=t(plan.rel_delays, np.int32),
        sub_delays=t(plan.sub_delays, np.int32),
        batch_of_dm=t(plan.batch_of_dm, np.int32),
        chan_weights=t(plan.chan_weights, np.float32),
        dms=tuple(float(d) for d in plan.dms),
        max_delay=int(plan.max_delay), max_sub_delay=int(plan.max_sub_delay),
        nsub=int(plan.nsub), nchan_eff=float(plan.nchan_eff),
        rel_delays_max=int(plan.rel_delays_max))
