"""System constants of the VLITE-Fast signal chain.

The port's own copy of the JAX package's vlite_fast_tpu/constants.py,
kept whole so that the port imports nothing of that package
(tests/test_torch_config.py holds the two equal).  They mirror the
compile-time geometry of the reference implementation (its
src/process_baseband.h:16-57 and src/def.h:15-23) so that the chain
produces filterbanks with identical geometry/labeling.  Unlike the
reference, nothing here is baked into kernels at compile time: the runtime
geometry lives in :mod:`vlite_fast_tpu_torch.config` and defaults to these
values.
"""

import math

# ---------------------------------------------------------------------------
# VDIF / capture geometry (ref: src/def.h:15-23, src/process_baseband.h:16-19)
# ---------------------------------------------------------------------------
VDIF_FRAME_BYTES = 5032          # 32-byte header + 5000 payload bytes
VDIF_HEADER_BYTES = 32
VDIF_DATA_BYTES = 5000           # 8-bit real samples per frame
VLITE_RATE = 128_000_000         # real samples/s per polarization
VLITE_FRAME_RATE = 25_600        # frames/s per polarization (thread)
FRAMES_PER_SEC = VLITE_FRAME_RATE
MAX_FRAME_NUM = FRAMES_PER_SEC - 1
NPOL = 2

# Band edges in MHz.  The sampled band is 320-384 MHz (second Nyquist zone of
# 128 Msps real sampling), spectrally inverted so rFFT bin 0 maps to 384 MHz.
FREQ_TOP_MHZ = 384.0
FREQ_BOT_MHZ = 320.0
BANDWIDTH_MHZ = 64.0

# ---------------------------------------------------------------------------
# Filterbank geometry (ref: src/process_baseband.h:20-28)
# ---------------------------------------------------------------------------
NFFT = 12500                     # samples per FFT (channelizer transform size)
NCHAN = NFFT // 2 + 1            # 6251 channels incl. DC
NSCRUNCH = 8                     # time-average factor after detection
SEG_PER_SEC = 320                # seconds processed as 320 x 3.125 ms chunks
# Segment-size sweep on TPU v5 lite (benchmarks/bench_segsize_tpu.py),
# f32 era: sps=5 3.9x / 10 4.8x / 20 5.9x / 40 6.6x / 64 10.8x /
# 80 11.9x / 160 11.7x.  Re-swept after the bf16x3 real-plane DFT
# (interleaved runs): 40 8.8x / 80 14.0x / 160 13.6x / 320 14.35x /
# 640 10.3x — 320 wins.  Small tiles keep each segment's
# detect->EMA->scrunch intermediates resident so the chain stops
# round-tripping HBM (640's 4-FFT segments tip into per-step overhead).
# The EMA state threads across segments, so seg_per_sec only re-tiles
# the execution (equivalent science, not bit identical: f32 association
# order shifts ~0.5% of samples by one 2-bit level and the second-0
# bandpass seed averages a shorter window).
FFTS_PER_SEG = VLITE_RATE // SEG_PER_SEC // NFFT   # 32 spectra / seg / pol
SEG_SAMPS = VLITE_RATE // SEG_PER_SEC              # 400 ksamp / seg / pol

# Output channel selection (ref: src/process_baseband.h:54-55). Channels are
# counted from DC; the retained band is 362 -> 320 MHz (4096 channels).
CHANMIN = 2155
CHANMAX = 6250
NCHANOUT = CHANMAX - CHANMIN + 1  # 4096

# Filterbank sample interval in seconds (781.25 us)
TSAMP = NFFT / VLITE_RATE * NSCRUNCH
# Channel bandwidth, negative because channel 0 is the highest frequency
# (ref: src/process_baseband.cu:162 "chbw = -64./NCHAN")
CHAN_BW_MHZ = -BANDWIDTH_MHZ / NCHAN
# Frequency of output channel 0 in a trimmed filterbank
# (ref: src/process_baseband.cu:261 "fch1 = 384+(CHANMIN-0.5)*chbw")
FCH1_MHZ = FREQ_TOP_MHZ + (CHANMIN - 0.5) * CHAN_BW_MHZ

# ---------------------------------------------------------------------------
# RFI excision (ref: src/process_baseband.h:35-46)
# ---------------------------------------------------------------------------
NKURTO = 500                     # samples per fine kurtosis window (3.9 us)
WINDOWS_PER_FFT = NFFT // NKURTO  # 25
DAG_THRESH = 3.0                 # 3-sigma threshold on fine-window TS
DAG_FB_THRESH = 5.0              # 5-sigma threshold on block TS
DAG_INF = DAG_THRESH + DAG_FB_THRESH + 1.0
MIN_WEIGHT = 0.2                 # drop samples with >80% RFI

# ---------------------------------------------------------------------------
# Quantization (ref: src/pb_kernels.cu:633-735)
# ---------------------------------------------------------------------------
# 2-bit thresholds optimized for chi^2_16-distributed powers with uniform
# output levels (ref: src/pb_kernels.cu:654-666)
QUANT2_THRESH = (-0.6109, 0.3970, 1.4050)
# Jenet & Anderson 1998 Table 3 scalings (ref: src/pb_kernels.cu:690-733)
QUANT4_SCALE = 0.3188
QUANT4_OFFSET = 7.5
QUANT8_SCALE = 0.02957
QUANT8_OFFSET = 127.5

# ---------------------------------------------------------------------------
# Bandpass EMA (ref: src/process_baseband.cu:737-741)
# ---------------------------------------------------------------------------
# scale = tsamp / tsmooth with tsmooth = 1 s; NB the reference computes the
# EMA update per *spectrum* (97.66 us) but scales with the post-scrunch tsamp.
BP_TSMOOTH = 1.0
BP_SCALE = TSAMP / BP_TSMOOTH
# detect_and_normalize3 clips powers above 11x the bandpass to 10
# (ref: src/pb_kernels.cu:493-494)
BP_CLIP_RATIO = 11.0
BP_CLIP_VALUE = 10.0

# ---------------------------------------------------------------------------
# Dispersion
# ---------------------------------------------------------------------------
# Dispersion constant in s * MHz^2 / (pc cm^-3); the reference uses both
# 4.15e-3 s*GHz^2 (src/pb_kernels.cu:344, src/trigger.py:33) and the more
# precise 4.148808e3 (src/candidate.py:33).
DM_CONST_S = 4.148808e3          # s MHz^2 / (pc/cm^3)
DM_CONST_REF = 4.15e3            # value the reference injection/trigger uses

# ---------------------------------------------------------------------------
# FRB injection (ref: src/process_baseband.cu:1238-1240, pb_kernels.cu:338-391)
# ---------------------------------------------------------------------------
INJECT_DM = 80.0
INJECT_WIDTH_S = 2e-3
INJECT_AMP = 1.05
INJECT_PERIOD_S = 60

# ---------------------------------------------------------------------------
# Trigger / coincidence defaults (ref: src/trigger.py:45,148, trigger.py:32)
# ---------------------------------------------------------------------------
TRIGGER_SNR = 7.5
# Coadd-beam candidates bypass the min_beams coincidence cut (the whole
# array already voted through the sum), so a lone Gaussian fluctuation in
# ONE stream must not clear the same bar multi-beam coincidence gates.
# 9.0 sigma ~ the joint false-alarm rate of two independent 7.5-sigma
# beams over the per-gulp trial count; real broadband events gain
# sqrt(N) in the coadd and clear it easily.
TRIGGER_COADD_SNR = 9.0
TRIGGER_MIN_BEAMS = 2
TRIGGER_MAX_WIDTH_S = 0.5
TRIGGER_MIN_DM = 20.0
MAX_DUMP_S = 20.0
# full-band dispersion delay per unit DM in seconds (ref: src/trigger.py:33)
DM_DELAY_PER_DM = DM_CONST_REF * 1e-3 * (0.320 ** -2 - 0.384 ** -2) / 1e3


def dagostino_constants(n: int) -> dict:
    """Constants of the D'Agostino kurtosis normality TS for sample size n.

    Mirrors the preprocessor math at reference src/pb_kernels.cu:3-20.
    Returns dict with mu1, mu2, g1, A, Z2_1, Z2_2, Z2_3.
    """
    nk = float(n)
    mu1 = -6.0 / (nk + 1)
    mu2 = (24.0 * nk * (nk - 2) * (nk - 3)) / (
        (nk + 1) * (nk + 1) * (nk + 3) * (nk + 5))
    g1 = (6.0 * (nk * nk - 5 * nk + 2) / ((nk + 7) * (nk + 9))
          * math.sqrt((6.0 * (nk + 3) * (nk + 5)) / (nk * (nk - 2) * (nk - 3))))
    a = 6.0 + (8.0 / g1) * (2.0 / g1 + math.sqrt(1.0 + 4.0 / (g1 * g1)))
    return {
        "mu1": mu1,
        "mu2": mu2,
        "g1": g1,
        "A": a,
        "Z2_1": math.sqrt(4.5 * a),
        "Z2_2": 1 - 2.0 / (9 * a),
        "Z2_3": math.sqrt(2.0 / (mu2 * (a - 4))),
    }


def dispersion_delay_s(dm: float, freq_mhz, ref_freq_mhz: float):
    """Cold-plasma dispersion delay (s) of freq relative to ref_freq.

    delay = K * DM * (f^-2 - fref^-2), K = 4.148808e3 s MHz^2 / (pc cm^-3).
    """
    return DM_CONST_S * dm * (freq_mhz ** -2.0 - ref_freq_mhz ** -2.0)


def channel_freqs_mhz(nchan: int = NCHAN):
    """Center frequency (MHz) of each un-trimmed filterbank channel.

    Channel i maps to rFFT bin i with descending sky frequency
    (ref: src/pb_kernels.cu:342 "freq = 0.384 - (i*0.064)/NCHAN" in GHz).
    """
    import numpy as np
    i = np.arange(nchan, dtype=np.float64)
    return 384.0 - (i * 64.0) / nchan
