// The fused DSP chain with both DFT stages batched, hand-written for
// Hopper (sm_90a).  Called through ctypes from
// ops/megakernel.py:chain_second_v4.
//
// Replaces the TPU kernel vlite_fast_tpu/ops/megakernel.py:chain_second_v4
// (body _full_kernel_v4): the same function as chain.cu, on the
// Cooley-Tukey-major tiles of ops/megakernel.pallas_pretranspose (u8
// bytes or bf16 converted voltages), with the DFT as two passes over all
// frames of a chunk of segments instead of chain.cu's one block per frame
// doing both stages:
//
//   front_kernel   (chain.cuh) the kurtosis gates, read from the tiles.
//   stage1_kernel  one block per (frame, stream): the frame's n2 live rows
//                  (masked by the keep flags for the kurtosis stream) in
//                  shared memory, the n1-point real DFTs over m1 for every
//                  row (k1 <= n1/2, the rest by conjugate symmetry) and the
//                  twiddle, written TRANSPOSED to a complex intermediate
//                  (frame, k1, m2) so stage 2 reads m2 contiguously (the
//                  TPU kernel's XLU "bridge").
//   stage2_kernel  one block per (frame, stream): the frame's (n1, n2)
//                  intermediate in shared memory, the n2-point DFTs over m2
//                  for the kept bins and |X|^2, written in natural channel
//                  order k = k1 + n1 * k2 (neighbouring threads, neighbouring
//                  k1, neighbouring channels).
//   bandpass_kernel, ema_kernel (chain.cuh) the EMAs, scrunches,
//                  thresholds, 2-bit pack.
//
// What bounds it: the same f32 FMA work as chain.cu's dft_kernel (~0.36
// TFLOP per data-second on the CUDA cores), plus one write and one read
// of the intermediate (2 streams x 20480 frames x n1 x n2 complex f32,
// ~2.1 GB per data-second at production).  The host walks the second in
// chunks of segments so the intermediate scratch stays near 256 MB.  Each
// thread keeps four outputs in registers so one shared-memory load feeds
// four complex FMAs.  Tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int KT = 4;   // outputs per thread per inner loop

// frames of segments [s0, s0 + nsegc): frame f = (s - s0) * nb + p * ffts
// + t; its tile is number s0 * nb + f of the CT-major input
template <class T>
__global__ void stage1_kernel(ChainParams P, const T* __restrict__ x,
                              const uint8_t* __restrict__ keep, int stream0,
                              int s0, int nfr, const float2* __restrict__ w1,
                              const float2* __restrict__ tw,
                              float2* __restrict__ inter) {
  extern __shared__ float xs[];      // (n2, n1 + 1): row m2, lane m1
  const int n1 = P.n1, n2 = P.n2, pitch = n1 + 1;
  const int nb = P.npol * P.ffts;
  const int f = blockIdx.x;
  const int b = f % nb;
  const int s = s0 + f / nb, p = b / P.ffts, t = b - p * P.ffts;
  const long long j = (long long)s * P.ffts + t;
  const bool masked = stream0 + (int)blockIdx.y == 1;
  const T* src = x + (((long long)s * nb + b) << 14);
  const uint8_t* kp = keep + j * P.wpf;
  for (int i = threadIdx.x; i < n1 * n2; i += blockDim.x) {
    const int m2 = i / n1, m1 = i - m2 * n1;
    float v = volt(src[m2 * 128 + m1]);
    if (masked && !kp[(m1 * n2 + m2) / P.nkurto]) v = 0.0f;
    xs[m2 * pitch + m1] = v;
  }
  __syncthreads();
  // A[k1, m2] = sum_m1 x[m1, m2] W_n1^{m1 k1} for k1 <= n1/2; real input
  // gives A[n1 - k1] = conj(A[k1])
  const int nk = n1 / 2 + 1;
  const int ngrp = blockDim.x / n2;
  const int m2 = threadIdx.x % n2, g = threadIdx.x / n2;
  if (g >= ngrp) return;
  float2* out = inter + ((long long)blockIdx.y * nfr + f) * n1 * n2;
  const float* xr = xs + m2 * pitch;
  for (int k0 = g * KT; k0 < nk; k0 += ngrp * KT) {
    float ar[KT], ai[KT];
    int kk[KT];
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      ar[q] = ai[q] = 0.0f;
      kk[q] = min(k0 + q, nk - 1);
    }
    for (int m1 = 0; m1 < n1; ++m1) {
      const float xv = xr[m1];
      const float2* wr = w1 + m1 * n1;
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        const float2 w = __ldg(&wr[kk[q]]);
        ar[q] = fmaf(xv, w.x, ar[q]);
        ai[q] = fmaf(xv, w.y, ai[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      const int k1 = k0 + q;
      if (k1 >= nk) break;
      const float2 tv = __ldg(&tw[k1 * n2 + m2]);
      out[k1 * n2 + m2] = make_float2(ar[q] * tv.x - ai[q] * tv.y,
                                      ar[q] * tv.y + ai[q] * tv.x);
      const int kc = n1 - k1;
      if (k1 > 0 && kc != k1) {
        const float2 tc = __ldg(&tw[kc * n2 + m2]);
        out[kc * n2 + m2] = make_float2(ar[q] * tc.x + ai[q] * tc.y,
                                        ar[q] * tc.y - ai[q] * tc.x);
      }
    }
  }
}

__global__ void stage2_kernel(ChainParams P, int s0, int nfr,
                              const float2* __restrict__ inter,
                              const float2* __restrict__ w2,
                              float* __restrict__ power) {
  extern __shared__ float sm2[];
  const int n1 = P.n1, n2 = P.n2;
  float* br = sm2;                   // (n1, n2) intermediate, re
  float* bi = br + n1 * n2;          //                        im
  const int nb = P.npol * P.ffts;
  const int f = blockIdx.x;
  const int b = f % nb;
  const int s = s0 + f / nb, p = b / P.ffts, t = b - p * P.ffts;
  const long long j = (long long)s * P.ffts + t;
  const float2* src = inter + ((long long)blockIdx.y * nfr + f) * n1 * n2;
  for (int i = threadIdx.x; i < n1 * n2; i += blockDim.x) {
    const float2 v = src[i];
    br[i] = v.x;
    bi[i] = v.y;
  }
  __syncthreads();
  // X[k1 + n1 k2] = sum_m2 B[k1, m2] W_n2^{m2 k2}, then |X|^2
  const int ngrp = blockDim.x / n1;
  const int k1 = threadIdx.x % n1, g = threadIdx.x / n1;
  if (g >= ngrp) return;
  float* out = power + (((long long)blockIdx.y * P.npol + p) * P.nblk + j) *
                           P.nchan;
  const float* rr = br + k1 * n2;
  const float* ri = bi + k1 * n2;
  for (int q0 = g * KT; q0 < P.n2_out; q0 += ngrp * KT) {
    float pr[KT], pi[KT];
    int kk[KT];
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      pr[q] = pi[q] = 0.0f;
      kk[q] = min(q0 + q, P.n2_out - 1);
    }
    for (int m2 = 0; m2 < n2; ++m2) {
      const float a = rr[m2], c = ri[m2];
      const float2* wr = w2 + m2 * P.n2_out;
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        const float2 w = __ldg(&wr[kk[q]]);
        pr[q] = fmaf(a, w.x, pr[q]);
        pr[q] = fmaf(-c, w.y, pr[q]);
        pi[q] = fmaf(a, w.y, pi[q]);
        pi[q] = fmaf(c, w.x, pi[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      const int k = k1 + n1 * (q0 + q);
      if (q0 + q < P.n2_out && k < P.nchan)
        out[k] = pr[q] * pr[q] + pi[q] * pi[q];
    }
  }
}

// threads per block: `rows` threads per group, as many groups as fit in
// 1024 threads and are useful (each group takes KT outputs at a time)
inline int block_threads(int rows, int nout) {
  const int useful = (nout + KT - 1) / KT;
  return rows * max(1, min(1024 / rows, useful));
}

template <class T>
int run_v4(const ChainParams& P, const T* x, const void* w1, const void* tw,
           const void* w2, const void* bp_in, void* power, void* keep,
           void* dagcnt, void* seeds, void* inter, int chunk, void* packed,
           void* packed_kur, void* weights, void* dag_frac, void* bp_out,
           cudaStream_t st) {
  cudaError_t e = launch_front(P, CtMajor<T>{x, P.npol, P.ffts, P.n2}, keep,
                               weights, dagcnt, st);
  if (e != cudaSuccess) return (int)e;
  const size_t sm1 = (size_t)P.n2 * (P.n1 + 1) * sizeof(float);
  const size_t sm2 = (size_t)2 * P.n1 * P.n2 * sizeof(float);
  if ((e = cudaFuncSetAttribute(stage1_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sm1)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(stage2_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sm2)) != cudaSuccess)
    return (int)e;
  const int nb = P.npol * P.ffts;
  const int th1 = block_threads(P.n2, P.n1 / 2 + 1);
  const int th2 = block_threads(P.n1, P.n2_out);
  for (int s0 = 0; s0 < P.nseg; s0 += chunk) {
    const int nfr = min(chunk, P.nseg - s0) * nb;
    const dim3 grid(nfr, num_streams(P));
    stage1_kernel<T><<<grid, th1, sm1, st>>>(
        P, x, (const uint8_t*)keep, first_stream(P), s0, nfr,
        (const float2*)w1, (const float2*)tw, (float2*)inter);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    stage2_kernel<<<grid, th2, sm2, st>>>(P, s0, nfr, (const float2*)inter,
                                          (const float2*)w2, (float*)power);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)launch_ema_streams(P, power, weights, seeds, bp_in, bp_out,
                                 packed, packed_kur, dagcnt, dag_frac, st);
}

}  // namespace

// ip (int64): chain_params' 11 (chain.cuh), then layout (1 CT-major u8,
//             2 CT-major bf16 tiles (nseg, npol * ffts * 128, 128)) and
//             the chunk in segments
// fp (f32):   chain_params' (chain.cuh)
// Device pointers as vf_chain_second's (chain.cu) without layout 0's
// partial / list / nlist, plus inter: complex f32 scratch (nstreams,
// chunk * npol * ffts, n1, n2).
// Launches on `stream`; returns cudaGetLastError() after the launches.
extern "C" int vf_chain_second_v4(const long long* ip, const float* fp,
                                  const void* in, const void* w1,
                                  const void* tw, const void* w2,
                                  const void* bp_in, void* power, void* keep,
                                  void* dagcnt, void* seeds, void* inter,
                                  void* packed,
                                  void* packed_kur, void* weights,
                                  void* dag_frac, void* bp_out,
                                  void* stream) {
  const ChainParams P = chain_params(ip, fp);
  const int layout = (int)ip[11], chunk = (int)ip[12];
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  if (layout == 1)
    return run_v4(P, (const uint8_t*)in, w1, tw, w2, bp_in, power, keep,
                  dagcnt, seeds, inter, chunk, packed, packed_kur, weights,
                  dag_frac, bp_out, st);
  if (layout == 2)
    return run_v4(P, (const __nv_bfloat16*)in, w1, tw, w2, bp_in, power,
                  keep, dagcnt, seeds, inter, chunk, packed, packed_kur,
                  weights, dag_frac, bp_out, st);
  return (int)cudaErrorInvalidValue;
}
