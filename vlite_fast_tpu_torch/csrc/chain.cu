// Fused DSP chain for one second of one antenna, hand-written for Hopper
// (sm_90a).  Called through ctypes from ops/megakernel.py: chain_second_v2
// (natural layout), chain_second and chain_second_v4 (Cooley-Tukey-major
// layouts).
//
// Replaces three TPU kernels of vlite_fast_tpu/ops/megakernel.py that
// compute one function in two input layouts: chain_second_v2 (body
// _full_kernel_v2) on the raw second, and chain_second (body _full_kernel)
// and chain_second_v4 (body _full_kernel_v4, its DFT stages batched on
// the TPU) on the CT-major tiles of pretranspose_u8 / pallas_pretranspose
// (u8 bytes or bf16 converted voltages).  All three use the split-plane
// bf16 DFT, and so does this file, for every layout.  Same function as the
// port's models/baseband_dsp.process_second with injection off and the
// sequential EMA.
//
// Three launches, the input read through a loader (front.cuh: NaturalU8,
// CtMajor<uint8_t>, CtMajor<__nv_bfloat16>; the front stages a CT block's
// tiles in frame order first):
//   1. front_kernel   (chain.cuh) one block per FFT block (both pols):
//                     the kurtosis gates, keep flags, weights, counts, and
//                     the list of blocks flagged in part (0 < kept < all).
//   2. dft_tc_kernel  (dft_tc.cuh) the split-plane bf16 DFT on the
//                     tensor cores (wgmma), the TPU kernels' own
//                     arithmetic: every frame of the second into the
//                     plain plane, then the masked frames of the listed
//                     blocks into the kurtosis plane.  A block whose
//                     windows were all kept has the plain power bit for
//                     bit (the same deterministic kernel on the same
//                     values), and one with none kept is never read, so
//                     the kurtosis stream needs a transform of its own
//                     only in the listed blocks.  Every loader puts the
//                     same bf16 frame in shared memory, so the three
//                     layouts give the same bits.
//   3. bandpass_kernel, ema_kernel (chain.cuh) the EMA: the bandpass
//                     recurrence, one thread per (stream, pol, channel),
//                     writing the bandpass each segment starts from; then
//                     one thread per (stream, segment, pol, channel): the
//                     normalized power, scrunches, thresholds and the
//                     2-bit pack.  The weighted stream reads the kurtosis
//                     plane in the listed blocks and the plain plane
//                     elsewhere.
//
// What bounds it: per data-second the DFT is ~0.82 TFLOP of padded bf16
// products (dft_tc.cuh: >= 0.83 ms at 989 TFLOP/s) times ~1.1 for the
// listed blocks; the power planes (~0.5 GB per plane) make one round trip
// through device memory (~0.3 ms at 3.35 TB/s for each of the EMA's two
// reads).  The bandpass is a sequential recurrence over 10240 spectra per
// (stream, pol, channel), ~25k threads; the rest of the EMA runs over
// segments in parallel.  The CT-major layouts add their relayout
// (pretranspose.cu, or torch) and read 16 KB (u8) or 32 KB (bf16) tiles
// for each 12.5 KB frame.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "dft_tc.cuh"

namespace {

// front (with the list of blocks flagged in part), the tensor-core DFT of
// every frame and of the listed masked frames, the EMA; the input read
// through `ld`, whose tiles have `ct` bytes an element (0: the raw
// second).  power: (2, npol, nblk, nchan) [plain; kurtosis] with rfi_mode
// > 0, else (npol, nblk, nchan).
template <class Ld>
int run_chain(const ChainParams& P, const Ld& ld, int ct, const void* a1,
              const void* tw, const void* b2, const void* bp_in, void* power,
              void* keep, void* dagcnt, void* seeds, void* partial,
              void* list, void* nlist, void* packed, void* packed_kur,
              void* weights, void* dag_frac, void* bp_out, cudaStream_t st) {
  const dft_tc::Geom G = dft_tc::make_geom(P.nfft, P.n1, P.n2, ct);
  if (!dft_tc::fits(G)) return (int)cudaErrorInvalidValue;
  const bool front = P.rfi_mode > 0;
  cudaError_t e = launch_front(P, ld, keep, weights, dagcnt, st,
                               front ? partial : nullptr, list, nlist);
  if (e != cudaSuccess) return (int)e;
  float* plain = (float*)power;
  float* kur = front ? plain + (long long)P.npol * P.nblk * P.nchan : plain;
  const dft_tc::Jobs<Ld> J{ld, P.npol, P.nblk, 0,
                           front ? (const int*)nlist : nullptr,
                           (const int*)list, (const uint8_t*)keep, P.wpf,
                           P.nkurto, plain, kur};
  const long long nframes = (long long)P.npol * P.nblk;
  if ((e = dft_tc::launch(G, J, front ? 2 * nframes : nframes, a1, tw, b2,
                          st)) != cudaSuccess)
    return (int)e;
  return (int)launch_ema(P, plain, kur, front ? partial : nullptr, weights,
                         seeds, bp_in, bp_out, packed, packed_kur, dagcnt,
                         dag_frac, st);
}

}  // namespace

// ip (int64): chain_params' 11 (chain.cuh), then layout: 0 the raw second
//             u8 (npol, nsamp); 1 CT-major u8 / 2 CT-major bf16 tiles
//             (nseg, npol * ffts * 128, 128), 16-byte aligned
// fp (f32):   chain_params' (chain.cuh)
// Device pointers: in (per layout); t1, t2, t3 the DFT's constants
// (ops/megakernel.tc_planes: W1 core matrices, twiddle in accumulator
// order, W2 core matrices); bp_in / bp_out f32 (2, npol, nchan); power
// f32 scratch (2 planes [plain; kurtosis] with rfi_mode > 0, else 1) of
// (npol, nblk, nchan); keep u8 scratch (nblk * wpf); dagcnt i32 (nseg),
// zeroed; seeds f32 scratch (2 npol nseg nchan + npol nseg) of the EMA
// launch; partial u8 (nblk), list i32 (nblk) and nlist i32 (1), zeroed:
// the front's list; packed / packed_kur u8 (nseg * nout, nbytes); weights
// f32 (npol, nblk); dag_frac f32 (nseg).
// Launches on `stream`; returns cudaGetLastError() after the launches.
extern "C" int vf_chain_second(const long long* ip, const float* fp,
                               const void* in, const void* t1,
                               const void* t2, const void* t3,
                               const void* bp_in, void* power, void* keep,
                               void* dagcnt, void* seeds, void* partial,
                               void* list, void* nlist, void* packed,
                               void* packed_kur,
                               void* weights, void* dag_frac, void* bp_out,
                               void* stream) {
  const ChainParams P = chain_params(ip, fp);
  const int layout = (int)ip[11];
  cudaStream_t st = (cudaStream_t)stream;
  if (layout == 0)
    return run_chain(P, NaturalU8{(const uint8_t*)in, P.nsamp, P.nfft}, 0,
                     t1, t2, t3, bp_in, power, keep, dagcnt, seeds, partial,
                     list, nlist, packed, packed_kur, weights, dag_frac,
                     bp_out, st);
  // the slices' bulk copies need 16-byte-aligned tiles
  if ((layout != 1 && layout != 2) || (uintptr_t)in % 16)
    return (int)cudaErrorInvalidValue;
  if (layout == 1)
    return run_chain(P, CtMajor<uint8_t>{(const uint8_t*)in, P.npol, P.ffts},
                     1, t1, t2, t3, bp_in, power, keep, dagcnt, seeds,
                     partial, list, nlist, packed, packed_kur, weights,
                     dag_frac, bp_out, st);
  return run_chain(P, CtMajor<__nv_bfloat16>{(const __nv_bfloat16*)in,
                                             P.npol, P.ffts},
                   2, t1, t2, t3, bp_in, power, keep, dagcnt, seeds, partial,
                   list, nlist, packed, packed_kur, weights, dag_frac,
                   bp_out, st);
}

// The EMA launch alone (tests): ip / fp as above (layout ignored); plain
// and kur f32 (npol, nblk, nchan), partial u8 (nblk) or null, weights f32
// (npol, nblk); the rest as vf_chain_second's.
extern "C" int vf_chain_ema(const long long* ip, const float* fp,
                            const void* plain, const void* kur,
                            const void* partial, const void* weights,
                            const void* bp_in, const void* dagcnt,
                            void* seeds, void* packed, void* packed_kur,
                            void* dag_frac, void* bp_out, void* stream) {
  const ChainParams P = chain_params(ip, fp);
  return (int)launch_ema(P, plain, kur, partial, weights, seeds, bp_in,
                         bp_out, packed, packed_kur, dagcnt, dag_frac,
                         (cudaStream_t)stream);
}
