"""The JAX package's gulp search at a gulp's own length: the reference for
the port's search of a stream's last gulp.

The JAX package pads a short gulp to gulp + overlap rows (one TPU program
for every gulp); the port searches the rows it is given.  Inside
`true_length()` the JAX package's SinglePulseSearch searches each gulp
over its own rows, through its own `_top_crossings` and
`_cands_from_crossings` (a short gulp is a shape of its own on the CPU),
so that a test can hold the port's stream, last gulp included, to the
JAX package's arithmetic.  A full gulp runs as the shipped methods run
it.  Nothing of the JAX package is edited: the methods are replaced for
the block's duration only.
"""

import contextlib

import jax.numpy as jnp
import pytest

from vlite_fast_tpu.models import search as jsearch


def _search(eng, rows, t_offset, nbit=0):
    crossings, shape = eng._top_crossings(jnp.asarray(rows), nbit=nbit)
    return eng._cands_from_crossings(crossings, shape, t_offset,
                                     rows.shape[0] - eng.overlap)


def _gulp(self, fb_block, t_offset=0):
    return _search(self, fb_block, t_offset)


def _gulp_packed(self, packed_block, nbit, t_offset=0):
    return _search(self, packed_block, t_offset, nbit)


def _gulp_device(self, packed_dev, nbit, t_offset, nvalid):
    # the JAX pipeline pads the device window; its rows past nvalid +
    # overlap are that padding
    return _search(self, packed_dev[:nvalid + self.overlap], t_offset, nbit)


@contextlib.contextmanager
def true_length():
    with pytest.MonkeyPatch.context() as mp:
        cls = jsearch.SinglePulseSearch
        mp.setattr(cls, "search_gulp", _gulp)
        mp.setattr(cls, "search_gulp_packed", _gulp_packed)
        mp.setattr(cls, "search_gulp_device", _gulp_device)
        yield
