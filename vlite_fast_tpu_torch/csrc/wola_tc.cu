// The pfb station's channelize and detect of one stream, hand-written for
// Hopper (sm_90a): the WOLA polyphase filterbank's frames, their
// Cooley-Tukey DFT on the tensor cores and |X|^2, in one launch.  Called
// through ctypes from ops/megakernel.py (wola_dft_detect_power).
//
// Replaces no TPU kernel: the JAX package's polyphase_channelize
// (vlite_fast_tpu/ops/channelize.py) is XLA, the WOLA then matmul_rfft's
// einsums at the configuration's dft_precision.  Here the port's torch
// passes of that path (ops/channelize.wola, matmul_rfft, normalize.detect:
// each frame of f32 written to device memory and read back several
// times) become dft_tc.cuh's persistent tensor-core DFT with the WOLA
// loader (dft_tc::Wola): each frame formed in f32 in tap order from the
// carried tail and the second, split into bf16 hi + lo, stage 1 in three
// passes (bf16x3, dft_precision "high"), stage 2 and detect as the chains'.
//
// What bounds it: operations.  Per data-second and stream (20480 frames of
// 12500 samples) the padded bf16 products are ~0.97 TFLOP (stage 1: 6
// planes of 128 x 128 x 112; stage 2: 12 of 128 x 64 x 128), >= 0.98 ms at
// 989 TFLOP/s; the bytes from device memory (the second once, 256 MB u8 or
// 1 GB f32, 512 MB of power out) 0.23-0.46 ms.  What sets its pace is the
// converter: each frame's 4 taps and its window come from L2 (~250-400 KB
// a frame) on the consumer warpgroups, ~1.5 ms a stream beyond the DFT's
// ~2.5 (PERF.md §6).  The design converts the next frame's slice
// behind the current one's stage-2 products, reads the window in its own
// order, and (the caller) transforms the masked stream only in the frames
// that differ from the plain stream's (a list of jobs, ops/megakernel
// .wola_masked_frames).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_tc.cuh"

namespace {

constexpr int kTaps = 4;    // the taps built (ops/megakernel.WOLA_TAPS)

template <class T>
cudaError_t launch_wola(const long long* ip, const void* x, const void* tail,
                        const void* win, const void* a1, const void* tw,
                        const void* b2, const int* list, const int* nlist,
                        void* power, cudaStream_t st) {
  const int npol = (int)ip[0], nfft = (int)ip[2];
  const long long nsamp = ip[1];
  const dft_tc::Geom G =
      dft_tc::make_geom(nfft, (int)ip[3], (int)ip[4], 0, 1);
  const long long nblk = nsamp / nfft;
  const dft_tc::Jobs<dft_tc::Wola<T, kTaps>> J{
      dft_tc::Wola<T, kTaps>{(const T*)x, (const float*)tail,
                             (const float4*)win, nsamp},
      npol, nblk, 0, nlist, list, nullptr, 0, 1, (float*)power, nullptr};
  return dft_tc::launch(G, J, npol * nblk, a1, tw, b2, st);
}

}  // namespace

// ip (int64): npol, nsamp, nfft, n1, n2, ntap, u8.  x (npol, nsamp): u8
// raw bytes (u8 = 1) or f32 voltages (u8 = 0); tail f32 (npol, (ntap - 1)
// * nfft), the stream's carried voltages; win the WOLA window in the
// converter's order (ops/megakernel.wola_window_tiles); a1 / tw / b2 the
// constants of ops/megakernel.tc_planes; list / nlist i32 on the device,
// the frames to transform (pol-major indices) and their count, or both
// null for every frame; power f32 (npol, nsamp / nfft, nfft / 2 + 1), of
// which only the listed rows are written.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a geometry or tap count it
// does not take).
extern "C" int vf_wola_dft_detect_power(const long long* ip, const void* x,
                                        const void* tail, const void* win,
                                        const void* a1, const void* tw,
                                        const void* b2, const void* list,
                                        const void* nlist, void* power,
                                        void* stream) {
  if (ip[5] != kTaps || ip[1] % ip[2]) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* l = (const int*)list;
  const int* n = (const int*)nlist;
  return (int)(ip[6] ? launch_wola<uint8_t>(ip, x, tail, win, a1, tw, b2, l,
                                            n, power, st)
                     : launch_wola<float>(ip, x, tail, win, a1, tw, b2, l, n,
                                          power, st));
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
