"""vlite_fast_tpu_torch — the PyTorch/CUDA port of vlite_fast_tpu.

One antenna's main path runs here on an NVIDIA Hopper card: the baseband
DSP chain (convert, spectral-kurtosis RFI excision, Cooley-Tukey
channelizer, EMA bandpass, scrunch, 2-bit pack), the two-stage subband
dedispersion search, and the host pipeline that feeds seconds and
clusters candidates.  The JAX package `vlite_fast_tpu` stays beside this
one as the reference the tests hold it against.

Layout mirrors the JAX package (same sub-package and module names):
  ops/      — torch ops and the wrappers of the hand-written CUDA kernels
              (ops/megakernel: chain_second_v2, chain_second,
              chain_second_v4, pallas_pretranspose, and the staged
              dft_detect_power and chain_second_plain;
              ops/rfi_pallas.rfi_front, ops/pallas_kernels' two EMAs,
              ops/dedisperse_pallas: dedisperse_pallas and
              dedisperse_pallas_rollsel)
  models/   — the composed DSP chain (the twin and the armed program)
              and the gulp search
  runtime/  — StationPipeline
  csrc/     — CUDA C++ sources, built by _build.py with nvcc on first use
  constants.py, config.py, utils/ — the port's own copies of the JAX
              package's jax-free host modules
  devices.py — entry points run on "cuda" unless the caller asks for
              the CPU; without a card they raise

This package imports torch and nothing of jax or of `vlite_fast_tpu`.
"""

from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig  # noqa: F401

__all__ = ["PipelineConfig", "SearchConfig"]
