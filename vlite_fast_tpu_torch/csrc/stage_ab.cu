// The staged chain on the tensor cores, hand-written for Hopper (sm_90a).
// Called through ctypes from ops/megakernel.py: dft_detect_power (kernel A)
// and chain_second_plain (kernel B).
//
// Replaces two TPU kernels of vlite_fast_tpu/ops/megakernel.py:
//   dft_detect_power   (body _stageA_kernel) stage A: convert, the
//                      split-plane bf16 Cooley-Tukey DFT, detect;
//   chain_second_plain (body _mk_stageB_kernel) stage B: stage A, then the
//                      plain stream's back end: the sequential EMA seeded
//                      per segment, pscrunch, tscrunch, 2-bit thresholds
//                      and the byte pack, the bandpass carried.
// The TPU kernels take CT-major tiles (an XLA relayout) and return factored
// (k2, k1) planes; here both read the raw second in its natural layout
// (front.cuh's NaturalU8) and write linear channels: stage A's power as
// (nseg, npol * ffts, nchan) f32, stage B's sel_and_dig rows (chanmin % 4
// realigned) and the (npol, nchan) bandpass.
//
//   A: dft_tc_kernel (dft_tc.cuh), one persistent block per SM walking
//      frames: the bf16 products on the tensor cores (wgmma, f32
//      accumulate), the intermediate in registers, raw frames brought in
//      by bulk copies ahead of the products.
//   B: the same kernel writing the chain's (npol, nblk, nchan) power
//      plane, then chain.cuh's EMA launch in rfi_mode 0, whose plain
//      stream is stage B's back end: the seed sum * (1/ffts) where bp == 0
//      (a mean of 0 seeds 1), b' = s p + (1 - s) b, p / b' - 1, pscrunch
//      sqrt(1/2) (v0 + v1) (npol 1: none), tscrunch sum * 1/sqrt(nscrunch),
//      QUANT2_THRESH, four channels per byte.
//
// What bounds it: operations.  Per data-second (20480 frames of 12500
// samples) the split-plane DFT is ~0.59 TFLOP of bf16 products as the TPU
// defines it (stage 1: 4 real products of 125 x 100 x 100 per frame;
// stage 2: 6 of 126 x 125 x 100), 0.6 ms at the card's 989 TFLOP/s (0.82
// TFLOP as the tensor cores pad it); its bytes (256 MB in, 512 MB of
// power out) take 0.23 ms at 3.35 TB/s.  dft_tc.cuh has the design.  B
// adds the EMA's walk over 10240 spectra and a round trip of the 512 MB
// power plane through device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "dft_tc.cuh"

// ip (int64): npol, nsamp, nfft, n1, n2, seg_per_sec.  raw u8 (npol,
// nsamp); a1 / tw / b2 the constants of ops/megakernel.tc_planes; power
// f32 (nseg, npol * ffts, nchan).  Returns cudaGetLastError() after the
// launch.
extern "C" int vf_dft_detect_power(const long long* ip, const void* raw,
                                   const void* a1, const void* tw,
                                   const void* b2, void* power,
                                   void* stream) {
  const int npol = (int)ip[0], nfft = (int)ip[2], nseg = (int)ip[5];
  const long long nsamp = ip[1];
  const dft_tc::Geom G = dft_tc::make_geom(nfft, (int)ip[3], (int)ip[4]);
  if (!dft_tc::fits(G)) return (int)cudaErrorInvalidValue;
  const int ffts = (int)(nsamp / nseg / nfft);
  const long long nblk = (long long)nseg * ffts;
  const dft_tc::Jobs<NaturalU8> J{
      NaturalU8{(const uint8_t*)raw, nsamp, nfft}, npol, nblk, ffts, nullptr,
      nullptr, nullptr, 0, 1, (float*)power, nullptr};
  return (int)dft_tc::launch(G, J, npol * nblk, a1, tw, b2,
                             (cudaStream_t)stream);
}

// ip (int64) and fp (f32): chain.cuh's chain_params with rfi_mode 0.
// raw u8 (npol, nsamp); a1 / tw / b2 as above; bp_in / bp_out f32 (npol,
// nchan); power f32 scratch (npol, nblk, nchan); dagcnt i32 (nseg)
// zeroed, seeds f32 (2 npol nseg nchan + npol nseg) and dag_frac f32
// (nseg) scratch of the EMA launch; packed u8 (nseg * nout, nbytes).
// Returns cudaGetLastError() after the launches.
extern "C" int vf_chain_second_plain(const long long* ip, const float* fp,
                                     const void* raw, const void* a1,
                                     const void* tw, const void* b2,
                                     const void* bp_in, void* power,
                                     void* dagcnt, void* seeds,
                                     void* dag_frac,
                                     void* packed, void* bp_out,
                                     void* stream) {
  const ChainParams P = chain_params(ip, fp);
  const dft_tc::Geom G = dft_tc::make_geom(P.nfft, P.n1, P.n2);
  if (P.rfi_mode != 0 || !dft_tc::fits(G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dft_tc::Jobs<NaturalU8> J{
      NaturalU8{(const uint8_t*)raw, P.nsamp, P.nfft}, P.npol, P.nblk, 0,
      nullptr, nullptr, nullptr, 0, 1, (float*)power, nullptr};
  cudaError_t e = dft_tc::launch(G, J, (long long)P.npol * P.nblk, a1, tw,
                                 b2, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ema(P, power, nullptr, nullptr, nullptr, seeds, bp_in,
                         bp_out, packed, nullptr, dagcnt, dag_frac, st);
}
