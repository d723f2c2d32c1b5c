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
              chain_second_v4 and pallas_pretranspose;
              ops/rfi_pallas.rfi_front, ops/pallas_kernels' two EMAs,
              ops/dedisperse_pallas)
  models/   — the composed DSP chain (the twin and the armed program)
              and the gulp search
  runtime/  — StationPipeline
  csrc/     — CUDA C++ sources, built by _build.py with nvcc on first use

This package imports torch and never jax.  From `vlite_fast_tpu` it uses
only the jax-free modules `config`, `constants` and `utils.*`.
"""

from vlite_fast_tpu.config import PipelineConfig, SearchConfig  # noqa: F401

__all__ = ["PipelineConfig", "SearchConfig"]
