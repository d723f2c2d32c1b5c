"""The port's synthetic baseband (models/synthesis, numpy) and coherent
dedispersion (ops/coherent on torch.fft) against the JAX package's, on
the CPU.

Bar: generate_vdif and generate_baseband byte-equal (the same numpy
generator and chirp); the dispersion kernel and the smearing arithmetic
equal; swap_sideband exact; apply_chirp and coherent_dedisperse within
rtol 1e-5 / atol 1e-5 of the JAX functions on unit-variance blocks of
2**14-2**16 points (two float32 FFT libraries round differently: ~1e-6
apart here).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vlite_fast_tpu.models import synthesis as jsyn
from vlite_fast_tpu.ops import coherent as jcoh
from vlite_fast_tpu_torch.models import synthesis as tsyn
from vlite_fast_tpu_torch.ops import coherent as tcoh

SYNTH = {
    "pulse": dict(tobs=2.0, dm=300.0, pulse_period=0.05, skip_period=16,
                  amp=0.4, seed=21, sample_rate=1_000_000,
                  freq_bot_mhz=320.0, bandwidth_mhz=0.5, buflen=250_000),
    "rfi": dict(tobs=1.0, dm=50.0, pulse_period=0.1, amp=0.2, seed=3,
                add_rfi=True, sample_rate=500_000, bandwidth_mhz=0.25,
                buflen=125_000),
    "pol_ratio": dict(tobs=1.0, dm=120.0, pulse_period=0.05, amp=0.3,
                      pol_ratio=0.5, seed=9, sample_rate=1_000_000,
                      bandwidth_mhz=0.5, buflen=250_000),
}


@pytest.mark.parametrize("case", sorted(SYNTH))
def test_generate_vdif_byte_equal(case):
    kw = SYNTH[case]
    assert [f.name for f in dataclasses.fields(tsyn.SynthConfig)] == \
        [f.name for f in dataclasses.fields(jsyn.SynthConfig)]
    got, tinfo = tsyn.generate_vdif(tsyn.SynthConfig(**kw), ref_epoch=40,
                                    start_second=1000, station_id=7)
    want, jinfo = jsyn.generate_vdif(jsyn.SynthConfig(**kw), ref_epoch=40,
                                     start_second=1000, station_id=7)
    assert got.tobytes() == want.tobytes()
    assert tinfo == jinfo
    assert tsyn.white_noise_uint8(5000, seed=2).tobytes() == \
        jsyn.white_noise_uint8(5000, seed=2).tobytes()


@pytest.mark.parametrize("dm,taper", [(30.0, True), (300.0, False)])
def test_dispersion_kernel_equal(dm, taper):
    got = tcoh.dispersion_kernel(20_000, dm, 0.5, 320.0, taper=taper,
                                 device="cpu")
    want = np.asarray(jcoh.dispersion_kernel(20_000, dm, 0.5, 320.0,
                                             taper=taper))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)
    for rate in (1e6, 128e6):
        assert tcoh.smearing_samples(dm, rate) == \
            jcoh.smearing_samples(dm, rate)


def _blocks(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, n)).astype(np.float32)


@pytest.mark.parametrize("n,dm,seed", [(2 ** 14, 30.0, 0),
                                       (50_000, 300.0, 1),
                                       (2 ** 16, 1000.0, 2)])
def test_apply_chirp_and_coherent_dedisperse_close(n, dm, seed):
    x = _blocks(n, seed)
    ker = jcoh.dispersion_kernel(n, dm, 0.5, 320.0)
    want = np.asarray(jcoh.apply_chirp(x, ker))
    got = tcoh.apply_chirp(torch.from_numpy(x),
                           tcoh.dispersion_kernel(n, dm, 0.5, 320.0,
                                                  device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jcoh.coherent_dedisperse(x, dm, 1e6, 0.5, 320.0))
    got = tcoh.coherent_dedisperse(torch.from_numpy(x), dm, 1e6, 0.5, 320.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_swap_sideband_exact():
    x = _blocks(1001, 4)
    got = tcoh.swap_sideband(torch.from_numpy(x)).numpy()
    assert got.tobytes() == np.asarray(jcoh.swap_sideband(x)).tobytes()


def test_dispersion_kernel_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcoh.dispersion_kernel(1000, 10.0)
