"""Typed configuration for the VLITE-Fast pipeline.

The port's own copy of the JAX package's vlite_fast_tpu/config.py: the
same dataclasses, fields, defaults, derived properties and validation
(tests/test_torch_config.py holds the two equal), importing the port's
`constants`.  Comments that name the TPU or Pallas describe how the JAX
package reads an option; the port reads them as ops/ and models/ say.

Collapses the reference's three config tiers — compile-time #defines
(src/process_baseband.h), per-binary getopt flags (src/process_baseband.cu:
334-470), and the cluster tables (config/hosts, config/coadd parsed by
src/utils.c:421-457) — into dataclasses (SURVEY.md section 5 "Config").

All DSP geometry is parameterized so tests can run shrunken configurations on
CPU while production uses the reference geometry; defaults reproduce the
reference exactly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple

from vlite_fast_tpu_torch import constants as C


@dataclass(frozen=True)
class PipelineConfig:
    """Per-antenna DSP chain geometry + options.

    Ref: compile-time constants src/process_baseband.h:16-57 and getopt flags
    src/process_baseband.cu:345-470 (npol -P, nbit -b, rfi_mode -r,
    inject -i).
    """

    sample_rate: int = C.VLITE_RATE        # real samples/s/pol
    npol_in: int = 2                       # input polarizations
    nfft: int = C.NFFT                     # channelizer transform length
    nscrunch: int = C.NSCRUNCH             # time-average factor
    seg_per_sec: int = C.SEG_PER_SEC       # processing chunks per second
    nkurto: int = C.NKURTO                 # fine kurtosis window
    chanmin: int = C.CHANMIN               # first retained channel (from DC)
    chanmax: int = C.CHANMAX               # last retained channel
    nbit: int = 2                          # output quantization (2/4/8)
    npol_out: int = 1                      # 1 = pscrunch, 2 = keep pols
    rfi_mode: int = 2                      # 0 none / 1 in-place / 2 dual-path
    inject_frb: bool = False
    inject_dm: float = C.INJECT_DM
    inject_width_s: float = C.INJECT_WIDTH_S
    inject_amp: float = C.INJECT_AMP
    # thresholds (ref src/process_baseband.h:35-46)
    ema_impl: str = "matmul"       # 'matmul' (affine scan as two small
                                   # lower-triangular matmuls — see
                                   # normalize._affine_scan_matmul) |
                                   # 'assoc' (log-depth scan) | 'scan'
                                   # (sequential lax.scan) | 'pallas'
                                   # (one-pass VMEM kernel, run once per
                                   # second OUTSIDE the segment scan).
                                   # MEASURED on-chip: matmul 50.7 vs
                                   # assoc 67.6 ms/data-second dual-
                                   # stream, 19.7x vs 14.8x RT (the
                                   # associative_scan tree lowers to
                                   # ~240 tiny pad/slice ops per
                                   # segment; the layout-preserving
                                   # einsum form fuses into detect->
                                   # normalize->scrunch with no
                                   # transpose copies),
                                   # benchmarks/bench_ema_matmul_tpu.py.
                                   # Earlier: assoc 4.79x RT vs pallas
                                   # 3.30x — hoisting the EMA out of the
                                   # scan breaks XLA's fusion and costs
                                   # ~2 GB of extra HBM round trips per
                                   # second, outweighing the one-pass
                                   # saving.  All variants agree with
                                   # the sequential reference to f32
                                   # rounding (tests/test_ops.py).
    channelizer: str = "matmul"    # 'matmul' (MXU Cooley-Tukey) | 'fft'
                                   # | 'pfb' (streaming WOLA polyphase;
                                   # sharper channel response; works with
                                   # every rfi_mode — WOLA weight
                                   # bookkeeping via ops.channelize
                                   # .pfb_weights)
    pfb_ntap: int = 4              # polyphase taps when channelizer='pfb'
    rfi_impl: str = "xla"          # 'xla' (ops/kurtosis graph form;
                                   # default BY MEASUREMENT) | 'pallas'
                                   # (ops/rfi_pallas fused single pass;
                                   # byte-identical output, ~10% slower
                                   # in-chain — see rfi_pallas docstring
                                   # for the measured A/B)
    batch_streams: bool = False    # rfi_mode=2: run both streams' DFT as
                                   # one 2x-batched call.  Measured SLOWER
                                   # twice (2x at the round-1 10x100 ms
                                   # f32 tiling; 79 vs 60 ms/s at the
                                   # 320-seg bf16x3-plane config) — the
                                   # concat doubles the live intermediate
                                   # and breaks XLA's producer/consumer
                                   # stream pipelining.  Kept as a knob
                                   # for future hardware re-tests.
    dft_precision: str = "high"    # MXU passes for the DFT matmuls:
                                   # 'high' (bf16x3; default BY
                                   # MEASUREMENT: chain 63.6 vs 73.2 ms
                                   # per data-second on-chip, 2-bit
                                   # output agreement 99.998%) |
                                   # 'highest' (bf16x6 ~= f32, ~1e-6
                                   # rel).  A pure-bf16 variant
                                   # ('default') was measured 37% wrong
                                   # in isolated bins and is rejected;
                                   # benchmarks/bench_dft_precision_tpu
                                   # .py + bench_chain_precision_tpu.py
    front_layout: str = "flat"     # 'flat' (default BY MEASUREMENT:
                                   # 52.4 vs 54.9 'mixed' vs 70.8
                                   # 'frames' ms/data-second on-chip) |
                                   # 'frames': reshape the uint8 bytes
                                   # ONCE into the DFT's (b, n1, n2)
                                   # Cooley-Tukey layout and run
                                   # convert/kurtosis/mask there
                                   # (kurtosis.rfi_excise_framed) |
                                   # 'mixed': stats flat, mask framed.
                                   # The hypothesis was that the flat
                                   # front's two f32 tile relayouts per
                                   # segment (~11 ms serialized in the
                                   # profile) were the next cost — but
                                   # XLA overlaps them with MXU work,
                                   # while the frame layout taxes every
                                   # elementwise op with padded (100,
                                   # 125)->(8x13, 128) tiles.  All three
                                   # produce byte-identical output
                                   # (tested).  benchmarks/
                                   # bench_front_layout_tpu.py
    dft_exact_input: bool = False  # exploit that 8-bit voltages are
                                   # EXACTLY bf16-representable: at
                                   # dft_precision='high', DFT stage 1
                                   # runs as 2 separate MXU passes vs
                                   # bf16x3's 3 fused, identical error
                                   # (the x_lo term is identically 0).
                                   # Default OFF BY MEASUREMENT: 67.4 vs
                                   # 65.0 ms/data-second in-chain — the
                                   # un-fused partial-product add costs
                                   # more than the saved pass (MXU is at
                                   # ~5% util; HBM passes are the chain
                                   # cost, same verdict as the fused-RFI
                                   # and one-pass-EMA attempts).
                                   # benchmarks/bench_dft_exactbf16_tpu
    dft_stage2: str = "direct"     # complex product form for the DFT's
                                   # second Cooley-Tukey stage: 'direct'
                                   # (4 real einsums; default BY
                                   # MEASUREMENT) | 'gauss' (the
                                   # 3-multiplication trick: m1=(br+bi)
                                   # w2r, m2=br(w2i-w2r), m3=bi(w2i+w2r)
                                   # — one fewer MXU pass, ~equal
                                   # rounding, 99.994% 2-bit agreement).
                                   # gauss measured SLOWER in-chain
                                   # (50.6 vs 49.9 ms/data-second): the
                                   # MXU is at ~6% util so the saved
                                   # pass buys nothing, while the br+bi
                                   # pre-add is a new elementwise HBM
                                   # pass — same verdict as
                                   # dft_exact_input.
                                   # benchmarks/bench_dft_gauss_tpu.py
    chain_impl: str = "xla"        # 'xla' (the fused-graph chain) |
                                   # 'megakernel' (ops/megakernel.py:
                                   # the whole segment — convert, RFI
                                   # front, CT DFT, detect, EMA,
                                   # scrunches, quantize, pack — as ONE
                                   # Pallas launch per second; every
                                   # intermediate VMEM-resident, HBM
                                   # touched once per segment).  Applies
                                   # to the injection-free program only
                                   # (the host-gated armed seconds always
                                   # run the XLA chain); parity bar is
                                   # >= 99.99% 2-bit agreement (EMA is
                                   # sequential-exact, DFT rounding
                                   # matches 'high'+exact-input).
                                   # 'megakernel2': the natural-layout
                                   # variant — no XLA pretranspose (the
                                   # measured 18 ms/data-s wall,
                                   # benchmarks/bench_pretranspose_tpu):
                                   # stage 1 per-frame aT.b dots,
                                   # stage 2 one batched dot/stream.
                                   # Measured 36.8 vs 44.4 ms/data-s
                                   # (1.21x, bench_megakernel_full_tpu).
                                   # 'megakernel3'/'megakernel3f': the
                                   # pretransposed kernel fed by the
                                   # Pallas MXU relayout instead of the
                                   # 18 ms XLA one (u8 blocks / bf16
                                   # converted voltages); byte-exact
                                   # vs 'megakernel'.
    twin_chain_impl: str = "auto"  # chain_impl for the pipeline's
                                   # INJECTION-FREE twin program (the
                                   # 58-of-60-seconds path, host gating
                                   # in runtime/pipeline.feed_second):
                                   # 'auto' = 'megakernel2' on the TPU
                                   # backend when the geometry supports
                                   # it (the measured 1.21x), else the
                                   # chain_impl; 'same' = always mirror
                                   # chain_impl (restores byte-exact
                                   # armed/twin parity); or an explicit
                                   # chain_impl value.  The megakernel
                                   # twin agrees with the armed XLA
                                   # program at >= 99.99% of 2-bit
                                   # levels (not byte-exact: its EMA is
                                   # sequential-exact, the chain's
                                   # 'matmul' EMA closed-form).
    dag_thresh: float = C.DAG_THRESH
    dag_fb_thresh: float = C.DAG_FB_THRESH  # block-scale TS gate (live:
                                   # zero-weights whole FFT blocks; the
                                   # reference computes but comments out
                                   # this gate, pb_kernels.cu:255-256)
    do_histo: bool = False         # DOHISTO raw-sample histograms
                                   # (ref pb_kernels.cu:321-336)
    min_weight: float = C.MIN_WEIGHT
    bp_tsmooth: float = C.BP_TSMOOTH
    freq_top_mhz: float = C.FREQ_TOP_MHZ
    bandwidth_mhz: float = C.BANDWIDTH_MHZ

    # --- derived geometry -------------------------------------------------
    @property
    def nchan(self) -> int:
        return self.nfft // 2 + 1

    @property
    def nchanout(self) -> int:
        return self.chanmax - self.chanmin + 1

    @property
    def seg_samps(self) -> int:
        """Real samples per segment per polarization."""
        return self.sample_rate // self.seg_per_sec

    @property
    def ffts_per_seg(self) -> int:
        return self.seg_samps // self.nfft

    @property
    def windows_per_fft(self) -> int:
        return self.nfft // self.nkurto

    @property
    def nwin_per_seg(self) -> int:
        return self.seg_samps // self.nkurto

    @property
    def tsamp(self) -> float:
        """Output filterbank sampling interval [s]."""
        return self.nfft / self.sample_rate * self.nscrunch

    @property
    def tspec(self) -> float:
        """Raw (pre-scrunch) spectrum interval [s]."""
        return self.nfft / self.sample_rate

    @property
    def bp_scale(self) -> float:
        """EMA bandpass update weight (ref src/process_baseband.cu:737-741)."""
        return self.tsamp / self.bp_tsmooth

    @property
    def out_samps_per_seg(self) -> int:
        return self.ffts_per_seg // self.nscrunch

    @property
    def chan_bw_mhz(self) -> float:
        return -self.bandwidth_mhz / self.nchan

    @property
    def fch1_mhz(self) -> float:
        return self.freq_top_mhz + (self.chanmin - 0.5) * self.chan_bw_mhz

    def freqs_mhz(self):
        """Sky frequency of each RETAINED channel (chanmin..chanmax),
        channel centers, descending (negative chan_bw).  The single
        source of the channel->frequency mapping — runtime, sharded step,
        and tests must all use this (a convention fix in one copy-pasted
        site would otherwise be invisible to the others)."""
        import numpy as _np
        return self.freq_top_mhz + (
            _np.arange(self.chanmin, self.chanmax + 1) - 0.5
        ) * self.chan_bw_mhz

    def __post_init__(self):
        if self.seg_samps % self.nfft:
            raise ValueError("seg_samps must be a multiple of nfft")
        if self.nfft % self.nkurto:
            raise ValueError("nfft must be a multiple of nkurto")
        if self.ffts_per_seg % self.nscrunch:
            raise ValueError("ffts_per_seg must be a multiple of nscrunch")
        if self.nbit not in (2, 4, 8):
            raise ValueError("nbit must be 2, 4 or 8")
        if self.rfi_impl not in ("xla", "pallas"):
            raise ValueError("rfi_impl must be 'xla' or 'pallas'")
        if self.front_layout not in ("frames", "mixed", "flat"):
            raise ValueError(
                "front_layout must be 'frames', 'mixed' or 'flat'")
        if self.dft_stage2 not in ("direct", "gauss"):
            raise ValueError("dft_stage2 must be 'direct' or 'gauss'")
        if self.batch_streams and (self.ema_impl == "pallas"
                                   or self.channelizer == "pfb"):
            # only the default per-segment scan path implements the
            # batched dual-stream DFT; fail loudly rather than silently
            # benchmarking the sequential path
            raise ValueError("batch_streams requires the default scan "
                             "path (ema_impl != 'pallas', "
                             "channelizer != 'pfb')")
        if self.dft_precision not in ("highest", "high"):
            raise ValueError("dft_precision must be 'highest' or 'high' "
                             "(pure-bf16 'default' is too inaccurate; see "
                             "benchmarks/bench_dft_precision_tpu.py)")
        if not 0 <= self.chanmin <= self.chanmax < self.nchan:
            raise ValueError(
                f"channel selection [{self.chanmin}, {self.chanmax}] "
                f"outside 0..{self.nchan - 1} (nfft {self.nfft})")
        samples_per_byte = 8 // self.nbit
        # per-ROW width is what pack_bits reshapes: the whole-segment
        # product can be byte-commensurate while a row is not
        if (self.nchanout * self.npol_out) % samples_per_byte:
            raise ValueError("channel/bit scheme is not byte-commensurate "
                             "(nchanout*npol_out must divide by "
                             f"{samples_per_byte} at {self.nbit}-bit; "
                             "ref src/process_baseband.cu:668-673)")

    @classmethod
    def tiny(cls, **overrides) -> "PipelineConfig":
        """A shrunken geometry for CPU tests: 12.5 kHz-rate analog."""
        kw = dict(
            sample_rate=1_000_000,  # 1 Msps
            nfft=500,
            nkurto=50,
            nscrunch=4,
            seg_per_sec=10,
            chanmin=16,
            chanmax=207,            # 192 output channels
            nbit=8,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclass(frozen=True)
class SearchConfig:
    """Incoherent-dedispersion single-pulse search (heimdall's role).

    Ref invocation: scripts/start_heimdall_single_antenna:21
    (-nsamps_gulp 30720 -dm 2 1000 -boxcar_max 64 -zap_chans 0 190
     -zap_chans 3900 4096).
    """

    dm_min: float = 2.0
    dm_max: float = 1000.0
    ndm: int = 1024                # trial count for dm_grid_mode='linear'
    dm_grid_mode: str = "tol"      # 'tol': tolerance-driven trial placement
                                   # (heimdall/dedisp -dm_tol semantics,
                                   # scripts/start_heimdall_single_antenna
                                   # :21) — the production default; trial
                                   # count follows dm_tol.  'linear': ndm
                                   # fixed trials (tests/benchmarks).
    dm_tol: float = 1.25           # S/N loss tolerance setting the DM grid
    gulp_samps: int = 15360        # samples per search gulp (12 s).
                                   # Re-decided from measurement after
                                   # the round-5 chain+dedisp speedups
                                   # (benchmarks/bench_gulpsize_tpu.py):
                                   #   gulp_s  cost/gulp  ms/data-s  latency
                                   #   24.0    0.127      5.3        32.8
                                   #   12.0    0.098      8.2        20.8
                                   #   8.0     0.083      10.4       16.8
                                   #   6.0     0.076      12.7       14.8
                                   #   3.0     0.066      22.1       11.8
                                   # 12 s keeps ~94% of station
                                   # capacity while the candidate-
                                   # latency bound (gulp + DM-1000
                                   # sweep) drops 32.8 -> 20.8 s data-
                                   # time — less than half the
                                   # reference's 40-50 s (ref
                                   # src/trigger.py:164-166; heimdall
                                   # used 24 s gulps,
                                   # scripts/start_heimdall_single_antenna:21)
    boxcar_max: int = 64           # max matched-filter width (power-of-2 set)
    snr_thresh: float = 6.0        # per-beam candidate threshold
    zap_ranges: Tuple[Tuple[int, int], ...] = ((0, 190), (3900, 4096))
    max_candidates: int = 4096     # static candidate-buffer size per gulp
    cluster_radius: int = 8        # samples; merge nearby boxcar peaks
    engine: str = "auto"           # 'auto' (pallas on TPU, subband off-TPU)
                                   # | 'pallas' (VMEM shift-and-sum, 4.9x
                                   # the fourier engine at production
                                   # geometry) | 'fourier' (dense phase
                                   # ramps) | 'subband' (gathers; faults
                                   # the TPU runtime at production size)
    nsub: int = 128                # subbands in the two-stage decomposition
    nbatch: int = 128              # stage-1 DM batches; 64 halves the
                                   # dominant traffic (47x vs 27x RT/gulp
                                   # measured) at ~4-sample worst-case
                                   # within-subband misalignment
    topk: int = 0                  # device->host crossing slots per gulp;
                                   # 0 = min(16 * max_candidates, 20000)
    topk_dm_bands: int = 8         # the device->host top-k return is
                                   # quota'd per contiguous DM band (k/nbands
                                   # slots each) so an RFI storm saturating
                                   # the low-DM trials cannot evict a real
                                   # high-DM pulse from the fixed-size
                                   # return (heimdall's analogous guard is
                                   # its giant-cluster limits); falls back
                                   # to one global band when ndm isn't a
                                   # multiple.  Saturated bands are counted
                                   # (vfast_topk_saturated_total).

    @classmethod
    def tiny(cls, **overrides) -> "SearchConfig":
        kw = dict(dm_min=0.0, dm_max=100.0, ndm=64, gulp_samps=512,
                  boxcar_max=16, zap_ranges=(), max_candidates=256,
                  dm_grid_mode="linear")
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def low_latency(cls, **overrides) -> "SearchConfig":
        """6 s gulps instead of the default 12 s: the candidate-latency
        bound drops 20.8 -> 14.8 s data-time (gulp + DM-1000 overlap;
        the reference documents 40-50 s, src/trigger.py:164-166) and
        the voltage-dump margin against the 32-60 s ring depth widens
        correspondingly (scripts/start_writer:12).  Measured on-chip
        with the fold engine (benchmarks/bench_gulpsize_tpu.py): search
        cost rises from 8.2 to 12.7 ms per data-second (the DM-1000
        overlap is re-dedispersed every gulp) — the trade a
        latency-sensitive deployment makes.
        """
        kw = dict(gulp_samps=7680)
        kw.update(overrides)
        return cls(**kw)


@dataclass(frozen=True)
class TriggerConfig:
    """Coincidencer cuts (ref src/trigger.py:45,148 and candidate.py:49-64)."""

    snr_thresh: float = C.TRIGGER_SNR
    # coadded-stream candidates carry the whole array's vote: no
    # min_beams cut, so the S/N bar is HIGHER to compensate for the
    # missing coincidence gate (see constants.TRIGGER_COADD_SNR)
    coadd_snr_thresh: float = C.TRIGGER_COADD_SNR
    min_beams: int = C.TRIGGER_MIN_BEAMS
    max_width_s: float = C.TRIGGER_MAX_WIDTH_S
    min_dm: float = C.TRIGGER_MIN_DM
    delta_dm: float = 0.1          # fractional DM agreement for overlap
    delta_w: float = 3.0           # max width ratio for overlap
    max_dump_s: float = C.MAX_DUMP_S
    buffer_pre_s: float = 0.1      # dump window padding (ref trigger.py:171)
    buffer_post_s: float = 0.2


@dataclass(frozen=True)
class AntennaConfig:
    """One antenna stream (one row of the reference's config/hosts table:
    hostname iface gpu ports keys ..., ref src/utils.c:421-457)."""

    station_id: int
    name: str = ""
    position_m: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # ECEF-ish
    source: str = "udp:20000"    # station data source: 'udp:PORT' (live
                                 # VDIF datagrams), 'raw:IFACE:PORT'
                                 # (AF_PACKET capture of UDP/IPv4-framed
                                 # VDIF off the wire — the reference's
                                 # production transport, src/utils.c:
                                 # 345-407) or 'file:PATH' (replay)
    host: str = ""               # where this station's daemon runs:
                                 # ''/localhost = spawned by `launch`
                                 # locally; anything else = ssh fan-out
                                 # (the config/hosts first column,
                                 # scripts/launch:5-12)


@dataclass(frozen=True)
class ArrayConfig:
    """The whole array + mesh layout (replaces config/hosts, config/coadd,
    and the OpenMPI hostfiles of the reference coadd path)."""

    antennas: Tuple[AntennaConfig, ...] = tuple(
        AntennaConfig(station_id=i + 1, name=f"ea{i + 1:02d}")
        for i in range(8))
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    trigger: TriggerConfig = field(default_factory=TriggerConfig)
    # mesh shape: antennas sharded over 'ant', search time blocks over 'time'
    mesh_ant: int = 1
    mesh_time: int = 1
    # service ports (the multicast group/port table role, multicast.h:10-26)
    command_port: int = 20001      # leader TCP command bus
    coincidencer_port: int = 27555  # candidate batches (trigger.py:37)
    trigger_port_base: int = 21000  # station k listens on base + station_id

    @property
    def nant(self) -> int:
        return len(self.antennas)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ArrayConfig":
        """Load a cluster config from JSON (the config/hosts +
        config/coadd + hostfile role as one typed file)."""
        d = json.loads(text)
        d["antennas"] = tuple(AntennaConfig(**{**a, "position_m":
                                               tuple(a.get("position_m",
                                                           (0, 0, 0)))})
                              for a in d.get("antennas", []))
        for key, klass in (("pipeline", PipelineConfig),
                           ("search", SearchConfig),
                           ("trigger", TriggerConfig)):
            if key in d and isinstance(d[key], dict):
                sub = d[key]
                if key == "search" and "zap_ranges" in sub:
                    sub["zap_ranges"] = tuple(tuple(z)
                                              for z in sub["zap_ranges"])
                d[key] = klass(**sub)
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "ArrayConfig":
        with open(path) as fp:
            return cls.from_json(fp.read())

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            fp.write(self.to_json())

    @classmethod
    def tiny(cls, nant: int = 4, mesh_ant: int = 1, mesh_time: int = 1,
             **overrides) -> "ArrayConfig":
        return cls(
            antennas=tuple(AntennaConfig(station_id=i + 1, name=f"ea{i+1:02d}")
                           for i in range(nant)),
            pipeline=PipelineConfig.tiny(),
            search=SearchConfig.tiny(),
            mesh_ant=mesh_ant, mesh_time=mesh_time, **overrides)


# The PipelineConfig variants one station is run under, by name: the JAX
# package's production config-matrix smoke walks the same list
# (benchmarks/smoke_config_matrix_tpu.py VARIANTS); chip_smoke.py runs each
# at the reference geometry and tests/test_torch_options.py at a small one.
CONFIG_MATRIX = (
    ("default (2-bit, rfi 2, matmul, assoc)", {}),
    ("4-bit output", {"nbit": 4}),
    ("8-bit output", {"nbit": 8}),
    ("dual-pol output", {"npol_out": 2}),
    ("rfi_mode 0", {"rfi_mode": 0}),
    ("rfi_mode 1", {"rfi_mode": 1}),
    ("PFB channelizer", {"channelizer": "pfb"}),
    ("pallas EMA", {"ema_impl": "pallas"}),
    ("pallas RFI front", {"rfi_impl": "pallas"}),
    ("scan EMA", {"ema_impl": "scan"}),
    ("dft highest", {"dft_precision": "highest"}),
    ("injection armed", {"inject_frb": True}),
    ("histograms on", {"do_histo": True}),
)
