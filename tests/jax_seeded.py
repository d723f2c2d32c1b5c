"""The JAX package's StationPipeline from the port's first bandpass: the
reference for the port's pipeline from an observation's start.

The port seeds an observation's first bandpasses from the EMA's own
length of spectra (vlite_fast_tpu_torch/models/baseband_dsp.seed_bandpass);
the JAX package seeds each from its first segment's tile.  Inside
`seeded()` the JAX package's StationPipeline.feed_second, on an
observation's first second (`_nsec == 0`), first sets its state's
bandpasses to the port's seed_bandpass of the same bytes, handed over as
numpy, so that a test holds the rest of the port's pipeline to the JAX
package's arithmetic.  Nothing of the JAX package is edited: the method
is replaced for the block's duration only.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlite_fast_tpu.runtime import pipeline as jpipe
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp


def port_seed(cfg, raw) -> tuple:
    """(bp, bp_kur) numpy: the port's seed_bandpass of the second `raw`
    (npol_in, sample_rate) uint8 from a fresh state, for the JAX package's
    PipelineConfig `cfg`."""
    tcfg = tconfig.PipelineConfig(**dataclasses.asdict(cfg))
    st = tdsp.seed_bandpass(
        tcfg, torch.from_numpy(np.ascontiguousarray(raw)),
        tdsp.init_state(tcfg, "cpu"))
    return st.bp.numpy(), st.bp_kur.numpy()


@contextlib.contextmanager
def seeded():
    feed = jpipe.StationPipeline.feed_second

    def feed_second(self, sec, buf):
        if self._nsec == 0:
            bp, bp_kur = port_seed(self.cfg, np.asarray(buf))
            self.state = self.state._replace(bp=jnp.asarray(bp),
                                             bp_kur=jnp.asarray(bp_kur))
        return feed(self, sec, buf)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.StationPipeline, "feed_second", feed_second)
        yield
