"""The port's StationPipeline searches a stream's last gulp over its own
rows, on the CPU.

- Pure noise whose last gulp holds the flush minimum of outputs (the
  pipeline searches a last gulp of more than overlap + 64 rows) or a
  little more, over several seeds: no candidate anywhere, the last gulp
  included.  Its noise is each DM's median over those few outputs alone.
- Every full gulp's packed crossings are bit-equal to the search's
  device program (search._device_gulp) on its gulp + overlap rows as
  the .fil holds them: the computation every full gulp ran before the
  last gulp stopped being padded.  The last gulp runs the same program
  on its own rows.
"""

import numpy as np
import pytest
import torch

from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline
from vlite_fast_tpu_torch.utils import sigproc

torch.set_num_threads(1)

NSEC = 3


def _seconds(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((cfg.npol_in, cfg.sample_rate))
                    / 0.05914 + 128.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


def _run(tmp_path, cfg, scfg, secs, write_fil=False):
    pipe = StationPipeline(1, cfg, scfg, out_dir=str(tmp_path),
                           keep_ring=False, write_cands=False, device="cpu")
    prod = pipe.run_observation(
        ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
        ObservationDocument(name="FLUSH", start_time=1.6e9),
        write_fil=write_fil)
    return pipe, prod


def _gulp_for(cfg, overlap, outputs):
    """The gulp length that leaves `outputs` outputs to NSEC seconds'
    last gulp."""
    rows = NSEC * cfg.seg_per_sec * cfg.out_samps_per_seg
    gulp = rows - overlap - outputs
    assert (rows - overlap) % gulp == outputs
    return gulp


@pytest.mark.parametrize("outputs", [65, 80, 128])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_short_flush_gulp_raises_no_candidate_on_noise(tmp_path, seed,
                                                       outputs):
    """3 s of noise, its last gulp 65 outputs (the flush minimum), 80 or
    128: the last gulp is searched at its own length and raises no
    candidate (in the JAX package's padded search such a gulp reads hot
    at its start: tests/test_torch_pipeline.py)."""
    cfg = tconfig.PipelineConfig.tiny(nbit=2)
    probe = tsearch.SinglePulseSearch(
        tconfig.SearchConfig.tiny(), cfg.tsamp, cfg.freqs_mhz(), nsub=64,
        nbatch=64, device="cpu")
    gulp = _gulp_for(cfg, probe.overlap, outputs)
    scfg = tconfig.SearchConfig.tiny(gulp_samps=gulp)
    seen = []
    real = tsearch.SinglePulseSearch._top_crossings
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsearch.SinglePulseSearch, "_top_crossings",
                   lambda self, fb, nbit=0: seen.append(fb.shape[0])
                   or real(self, fb, nbit))
        pipe, prod = _run(tmp_path, cfg, scfg, _seconds(cfg, NSEC, seed))
    assert seen == [gulp + probe.overlap, outputs + probe.overlap]
    assert prod.candidates == []
    assert pipe.search.last_gulp_stats["n_crossings"] == 0


def test_full_gulps_bit_equal_to_the_device_program(tmp_path):
    """An FRB armed at second 0, 5 s, 512-sample gulps: every gulp's
    crossings equal search._device_gulp's on its rows from the .fil, bit
    for bit; the full gulps take gulp + overlap rows, the last gulp only
    the rows the stream has."""
    cfg = tconfig.PipelineConfig.tiny(inject_frb=True, nbit=2,
                                      inject_dm=60.0, inject_amp=2.0,
                                      inject_width_s=8e-3)
    scfg = tconfig.SearchConfig.tiny()
    seen = []
    real = tsearch.SinglePulseSearch._top_crossings

    def record(self, fb, nbit=0):
        got = real(self, fb, nbit)
        seen.append((fb.clone(), got[0].clone()))
        return got
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsearch.SinglePulseSearch, "_top_crossings", record)
        pipe, prod = _run(tmp_path, cfg, scfg, _seconds(cfg, 5, 17),
                          write_fil=True)
    eng = pipe.search
    with open(prod.fil_path, "rb") as fp:
        sigproc.read_header(fp)
        rows = np.frombuffer(fp.read(), np.uint8).reshape(
            -1, cfg.nchanout * cfg.nbit // 8)
    full = scfg.gulp_samps + eng.overlap
    nfull = (rows.shape[0] - eng.overlap) // scfg.gulp_samps
    assert len(seen) == nfull + 1 and nfull >= 2
    k = scfg.topk or min(16 * scfg.max_candidates, 20000)
    for g, (fb, crossings) in enumerate(seen):
        start = g * scfg.gulp_samps
        want_rows = rows[start:start + full]
        assert fb.shape[0] == (full if g < nfull else rows.shape[0] - start)
        np.testing.assert_array_equal(fb.numpy(), want_rows)
        want = tsearch._device_gulp(
            torch.from_numpy(want_rows.copy()), eng.plan, widths=eng.widths,
            k=k, nbit=cfg.nbit, nchan=cfg.nchanout, nbands=eng.nbands,
            thresh=float(scfg.snr_thresh), engine=eng.engine)
        assert torch.equal(crossings, want), g
    best = max(prod.candidates, key=lambda c: c.snr)
    assert abs(best.dm - 60.0) < 10.0
