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
// sequential EMA.  The input reaches the front and the DFT through a
// loader of front.cuh (layout 0 natural u8, 1 CT-major u8, 2 CT-major
// bf16); every layout feeds the same samples to the same sums in the same
// order, so the three give bit-equal outputs.
//
//   1. front_kernel   (chain.cuh) one block per FFT block (both pols):
//                     the kurtosis gates, keep flags, weights, counts.
//   2. dft_kernel     one block per (frame, stream): the frame (masked by
//                     the keep flags for the kurtosis stream) in shared
//                     memory, Cooley-Tukey stage 1 (n1-point real DFTs
//                     down the columns, only k1 <= n1/2, the rest by
//                     conjugate symmetry) with the twiddle, stage 2
//                     (n2-point DFTs, only the nfft/2+1 bins kept), |X|^2.
//   3. ema_kernel     (chain.cuh) one thread per (stream, channel): the
//                     EMAs, scrunches, thresholds and the 2-bit pack.
//
// What bounds it: the DFT is ~11 MFLOP per 12500-point frame, 40960
// frames per data-second (2 pols x 2 streams), ~0.45 TFLOP/s of f32 FMA
// work at real time, against 67 TFLOP/s of f32 on the card; the power
// planes (2 x 2 x 10240 x 6251 f32, 1 GB) make one round trip through
// device memory.  The EMA is a sequential recurrence over 10240 spectra:
// its parallelism is channels x streams (~12.5k threads), so it is bound
// by load latency, not bandwidth.  The simple design takes both costs:
// f32 FMA on the CUDA cores (no tensor cores, no bf16 split planes),
// the frame and stage-1 planes in 150 KB of shared memory, one block per
// SM.  Keeping the power planes on chip and the DFT on tensor cores is
// later work.  The CT-major layout reads each frame's 128-byte rows
// coalesced into the same shared-memory frame, so the DFT's cost does not
// change with the layout; the front's strided reads of a CT tile hit L1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

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
              void* keep, void* dagcnt, void* packed, void* packed_kur,
              void* weights, void* dag_frac, void* bp_out, cudaStream_t st) {
  cudaError_t e;
  if ((e = launch_front(P, ld, keep, weights, dagcnt, st)) != cudaSuccess)
    return (int)e;
  if ((e = launch_dft(P, ld, keep, w1, tw, w2, power, st)) != cudaSuccess)
    return (int)e;
  return (int)launch_ema(P, power, weights, bp_in, bp_out, packed,
                         packed_kur, dagcnt, dag_frac, st);
}

}  // namespace

// ip (int64): chain_params' 11 (chain.cuh), then layout: 0 the raw second
//             u8 (npol, nsamp); 1 CT-major u8 / 2 CT-major bf16 tiles
//             (nseg, npol * ffts * 128, 128)
// fp (f32):   chain_params' (chain.cuh)
// Device pointers: in (per layout); w1 complex (n1, n1); tw complex
// (n1, n2); w2 complex (n2, n2_out); bp_in / bp_out f32 (2, npol, nchan);
// power f32 scratch (nstreams, npol, nblk, nchan); keep u8 scratch
// (nblk * wpf); dagcnt i32 (nseg), zeroed; packed / packed_kur u8
// (nseg * nout, nbytes); weights f32 (npol, nblk); dag_frac f32 (nseg).
// Launches on `stream`; returns cudaGetLastError() after the launches.
extern "C" int vf_chain_second(const long long* ip, const float* fp,
                               const void* in, const void* w1,
                               const void* tw, const void* w2,
                               const void* bp_in, void* power, void* keep,
                               void* dagcnt, void* packed, void* packed_kur,
                               void* weights, void* dag_frac, void* bp_out,
                               void* stream) {
  const ChainParams P = chain_params(ip, fp);
  const int layout = (int)ip[11];
  cudaStream_t st = (cudaStream_t)stream;
  if (layout == 0)
    return run_chain(P, NaturalU8{(const uint8_t*)in, P.nsamp, P.nfft}, w1,
                     tw, w2, bp_in, power, keep, dagcnt, packed, packed_kur,
                     weights, dag_frac, bp_out, st);
  if (layout == 1)
    return run_chain(P, CtMajor<uint8_t>{(const uint8_t*)in, P.npol, P.ffts,
                                         P.n2},
                     w1, tw, w2, bp_in, power, keep, dagcnt, packed,
                     packed_kur, weights, dag_frac, bp_out, st);
  if (layout == 2)
    return run_chain(P, CtMajor<__nv_bfloat16>{(const __nv_bfloat16*)in,
                                               P.npol, P.ffts, P.n2},
                     w1, tw, w2, bp_in, power, keep, dagcnt, packed,
                     packed_kur, weights, dag_frac, bp_out, st);
  return (int)cudaErrorInvalidValue;
}
