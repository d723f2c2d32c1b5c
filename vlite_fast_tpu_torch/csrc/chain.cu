// Fused DSP chain for one second of one antenna, hand-written for Hopper
// (sm_90a).  Called through ctypes from ops/megakernel.py: chain_second_v2
// (natural layout) and chain_second (Cooley-Tukey-major layout).
//
// Replaces two TPU kernels of vlite_fast_tpu/ops/megakernel.py that
// compute one function in two input layouts: chain_second_v2 (body
// _full_kernel_v2) on the raw second, and chain_second (body _full_kernel)
// on the CT-major blocks of pretranspose_u8 / pallas_pretranspose (u8
// bytes or bf16 converted voltages).  Same function as the port's
// models/baseband_dsp.process_second with injection off and the
// sequential EMA.
//
// Natural layout (chain_second_v2), three launches:
//   1. front_kernel   (chain.cuh) one block per FFT block (both pols):
//                     the kurtosis gates, keep flags, weights, counts, and
//                     the list of blocks flagged in part (0 < kept < all).
//   2. dft_tc_kernel  (dft_tc.cuh) the split-plane bf16 DFT on the
//                     tensor cores (wgmma), the TPU kernel's own
//                     arithmetic: every frame of the raw second into the
//                     plain plane, then the masked frames of the listed
//                     blocks into the kurtosis plane.  A block whose
//                     windows were all kept has the plain power bit for
//                     bit (the same deterministic kernel on the same
//                     values), and one with none kept is never read, so
//                     the kurtosis stream needs a transform of its own
//                     only in the listed blocks.
//   3. bandpass_kernel, ema_kernel (chain.cuh) the EMA: the bandpass
//                     recurrence, one thread per (stream, pol, channel),
//                     writing the bandpass each segment starts from; then
//                     one thread per (stream, segment, pol, channel): the
//                     normalized power, scrunches, thresholds and the
//                     2-bit pack.  The weighted stream reads the kurtosis
//                     plane in the listed blocks and the plain plane
//                     elsewhere.
// CT-major layouts (chain_second): the front, then dft_kernel below, an
// f32 direct DFT on the CUDA cores, one block per (frame, stream) with
// the frame and its stage-1 planes in shared memory (both streams in
// full), then the same EMA launch.
//
// What bounds it: per data-second the natural layout's DFT is ~0.82
// TFLOP of padded bf16 products (dft_tc.cuh: >= 0.83 ms at 989 TFLOP/s)
// times ~1.1 for the listed blocks; the power planes (~0.5 GB per plane)
// make one round trip through device memory (~0.3 ms at 3.35 TB/s for
// each of the EMA's two reads).  The bandpass is a sequential recurrence
// over 10240 spectra per (stream, pol, channel), ~25k threads; the rest of
// the EMA runs over segments in parallel.  The CT-major layouts' f32 DFT
// does ~0.36 TFLOP of FMA on the CUDA cores (>= 5.4 ms at 67 TFLOP/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "dft_tc.cuh"

namespace {

template <class Load>
__global__ void __launch_bounds__(512)
    dft_kernel(ChainParams P, Load ld, const uint8_t* __restrict__ keep,
               int stream0, const float2* __restrict__ w1,
               const float2* __restrict__ tw, const float2* __restrict__ w2,
               float* __restrict__ power) {
  extern __shared__ float sm[];
  float* xs = sm;             // (n1, n2) frame, row m1, column m2
  float* br = xs + P.nfft;    // (n1, n2) stage-1 output after twiddle, re
  float* bi = br + P.nfft;    //                                        im
  const int n1 = P.n1, n2 = P.n2;
  const int f = blockIdx.x;
  const int p = f / P.nblk, j = f - p * P.nblk;
  ld.frame(p, j, n1, n2, keep + (long long)j * P.wpf, P.nkurto,
           stream0 + (int)blockIdx.y == 1, xs);
  __syncthreads();
  // stage 1: A[k1, m2] = sum_m1 x[m1, m2] W_n1^{m1 k1}, k1 <= n1/2;
  // real input gives A[n1 - k1] = conj(A[k1])
  const int half = n1 / 2;
  for (int idx = threadIdx.x; idx < (half + 1) * n2; idx += blockDim.x) {
    const int k1 = idx / n2, m2 = idx - k1 * n2;
    float ar = 0.0f, ai = 0.0f;
    for (int m1 = 0; m1 < n1; ++m1) {
      const float x = xs[m1 * n2 + m2];
      const float2 w = __ldg(&w1[m1 * n1 + k1]);
      ar = fmaf(x, w.x, ar);
      ai = fmaf(x, w.y, ai);
    }
    const float2 t = __ldg(&tw[k1 * n2 + m2]);
    br[k1 * n2 + m2] = ar * t.x - ai * t.y;
    bi[k1 * n2 + m2] = ar * t.y + ai * t.x;
    const int kc = n1 - k1;
    if (k1 > 0 && kc != k1) {
      const float2 tc = __ldg(&tw[kc * n2 + m2]);
      br[kc * n2 + m2] = ar * tc.x + ai * tc.y;
      bi[kc * n2 + m2] = ar * tc.y - ai * tc.x;
    }
  }
  __syncthreads();
  // stage 2: X[k1 + n1 k2] = sum_m2 B[k1, m2] W_n2^{m2 k2}, then |X|^2
  float* out = power + (((long long)blockIdx.y * P.npol + p) * P.nblk + j) *
                           P.nchan;
  for (int k = threadIdx.x; k < P.nchan; k += blockDim.x) {
    const int k2 = k / n1, k1 = k - k2 * n1;
    const float* rr = br + k1 * n2;
    const float* ri = bi + k1 * n2;
    float pr = 0.0f, pi = 0.0f;
    for (int m2 = 0; m2 < n2; ++m2) {
      const float2 w = __ldg(&w2[m2 * P.n2_out + k2]);
      const float a = rr[m2], b = ri[m2];
      pr = fmaf(a, w.x, pr);
      pr = fmaf(-b, w.y, pr);
      pi = fmaf(a, w.y, pi);
      pi = fmaf(b, w.x, pi);
    }
    out[k] = pr * pr + pi * pi;
  }
}

template <class Load>
cudaError_t launch_dft(const ChainParams& P, const Load& ld, const void* keep,
                       const void* w1, const void* tw, const void* w2,
                       void* power, cudaStream_t st) {
  const size_t smem = (size_t)3 * P.nfft * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dft_kernel<Load>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dft_kernel<<<dim3(P.npol * P.nblk, num_streams(P)), 512, smem, st>>>(
      P, ld, (const uint8_t*)keep, first_stream(P), (const float2*)w1,
      (const float2*)tw, (const float2*)w2, (float*)power);
  return cudaGetLastError();
}

template <class Load>
int run_chain(const ChainParams& P, const Load& ld, const void* w1,
              const void* tw, const void* w2, const void* bp_in, void* power,
              void* keep, void* dagcnt, void* seeds, void* packed,
              void* packed_kur, void* weights, void* dag_frac, void* bp_out,
              cudaStream_t st) {
  cudaError_t e;
  if ((e = launch_front(P, ld, keep, weights, dagcnt, st)) != cudaSuccess)
    return (int)e;
  if ((e = launch_dft(P, ld, keep, w1, tw, w2, power, st)) != cudaSuccess)
    return (int)e;
  return (int)launch_ema_streams(P, power, weights, seeds, bp_in, bp_out,
                                 packed, packed_kur, dagcnt, dag_frac, st);
}

// The natural layout: front (with the list of blocks flagged in part),
// the tensor-core DFT of every frame and of the listed masked frames,
// the EMA.  power: (2, npol, nblk, nchan) [plain; kurtosis] with rfi_mode
// > 0, else (npol, nblk, nchan).
int run_natural(const ChainParams& P, const uint8_t* raw, const void* a1,
                const void* tw, const void* b2, const void* bp_in,
                void* power, void* keep, void* dagcnt, void* seeds,
                void* partial, void* list, void* nlist, void* packed,
                void* packed_kur,
                void* weights, void* dag_frac, void* bp_out,
                cudaStream_t st) {
  const dft_tc::Geom G = dft_tc::make_geom(P.nfft, P.n1, P.n2);
  if (!dft_tc::fits(G)) return (int)cudaErrorInvalidValue;
  const NaturalU8 ld{raw, P.nsamp, P.nfft};
  const bool front = P.rfi_mode > 0;
  cudaError_t e = launch_front(P, ld, keep, weights, dagcnt, st,
                               front ? partial : nullptr, list, nlist);
  if (e != cudaSuccess) return (int)e;
  float* plain = (float*)power;
  float* kur = front ? plain + (long long)P.npol * P.nblk * P.nchan : plain;
  const dft_tc::Jobs J{ld, P.npol, P.nblk, 0,
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
//             (nseg, npol * ffts * 128, 128)
// fp (f32):   chain_params' (chain.cuh)
// Device pointers: in (per layout); t1, t2, t3 the DFT's constants:
// layout 0 ops/megakernel.tc_planes (W1 core matrices, twiddle in
// accumulator order, W2 core matrices), layouts 1-2 w1 complex (n1, n1),
// tw complex (n1, n2), w2 complex (n2, n2_out); bp_in / bp_out f32 (2,
// npol, nchan); power f32 scratch (layout 0: 2 planes [plain; kurtosis]
// with rfi_mode > 0, else 1; layouts 1-2: one per stream the rfi_mode
// computes) of (npol, nblk, nchan); keep u8 scratch (nblk * wpf); dagcnt
// i32 (nseg), zeroed; seeds f32 scratch (2 npol nseg nchan + npol nseg)
// of the EMA launch; partial u8 (nblk), list i32 (nblk) and nlist i32
// (1), zeroed: layout 0's scratch; packed / packed_kur u8 (nseg * nout,
// nbytes); weights f32 (npol, nblk); dag_frac f32 (nseg).
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
    return run_natural(P, (const uint8_t*)in, t1, t2, t3, bp_in, power,
                       keep, dagcnt, seeds, partial, list, nlist, packed,
                       packed_kur, weights, dag_frac, bp_out, st);
  if (layout == 1)
    return run_chain(P, CtMajor<uint8_t>{(const uint8_t*)in, P.npol, P.ffts,
                                         P.n2},
                     t1, t2, t3, bp_in, power, keep, dagcnt, seeds, packed,
                     packed_kur, weights, dag_frac, bp_out, st);
  if (layout == 2)
    return run_chain(P, CtMajor<__nv_bfloat16>{(const __nv_bfloat16*)in,
                                               P.npol, P.ffts, P.n2},
                     t1, t2, t3, bp_in, power, keep, dagcnt, seeds, packed,
                     packed_kur, weights, dag_frac, bp_out, st);
  return (int)cudaErrorInvalidValue;
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
