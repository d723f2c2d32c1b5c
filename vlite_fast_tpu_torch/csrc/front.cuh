// The spectral-kurtosis RFI front of one FFT block, shared by the chain
// kernels (chain.cuh, front_kernel) and the armed program's front
// (rfi_front.cu).  Same statistics as the port's ops/kurtosis.rfi_excise
// and the JAX package's ops/rfi_pallas._front_kernel: convert, m2 and m4
// per nkurto window, the D'Agostino TS pol-combined by max, the block TS
// over the windows that passed the fine gate, and the two gates.
//
// Arithmetic uses the unfused __fmul_rn / __fadd_rn so the gates round as
// the plain torch version and the JAX reference do (no contraction into
// FMA); means are sum * (1/n), the form XLA gives jnp.mean.
//
// The voltages reach the front (and chain.cu's DFT) through a loader:
// ld(p, j, n) is sample n of FFT block j of pol p, converted, and
// ld.frame() fills a frame in shared memory.  NaturalU8 reads the raw
// second, CtMajor the Cooley-Tukey-major tiles of
// ops/megakernel.pallas_pretranspose.  Every layout sums the same samples
// in the same order, so the statistics are bit-equal across layouts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct DagK {
  float c1, mu1, z21, z22, z23;  // D'Agostino constants (constants.py)
};

__device__ __forceinline__ float conv_u8(uint8_t u) {
  return u == 0 ? 0.0f : (float)u * 0.0078125f - 1.0f;  // exact
}

// the voltage of one stored sample: a raw byte, or a voltage the bf16
// pretranspose already converted (exact in bf16)
__device__ __forceinline__ float volt(uint8_t u) { return conv_u8(u); }
__device__ __forceinline__ float volt(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The raw second, (npol, nsamp) u8: block j holds samples [j*nfft,
// (j+1)*nfft) of each pol.
struct NaturalU8 {
  const uint8_t* raw;
  long long nsamp;
  int nfft;
  __device__ __forceinline__ float operator()(int p, long long j,
                                              int n) const {
    return conv_u8(raw[(long long)p * nsamp + j * nfft + n]);
  }
  // xs[n] = sample n of the frame (zero where keep[n / nkurto] == 0 when
  // `masked`); neighbouring threads read neighbouring bytes
  __device__ __forceinline__ void frame(int p, long long j, int n1, int n2,
                                        const uint8_t* keep, int nkurto,
                                        bool masked, float* xs) const {
    const uint8_t* src = raw + (long long)p * nsamp + j * nfft;
    for (int i = threadIdx.x; i < nfft; i += blockDim.x) {
      float x = conv_u8(src[i]);
      if (masked && !keep[i / nkurto]) x = 0.0f;
      xs[i] = x;
    }
  }
};

// Cooley-Tukey-major tiles, (nseg, npol * ffts * 128, 128) of T (u8 raw
// bytes or bf16 converted voltages): block j = s * ffts + t of pol p is
// the 128 x 128 tile number (s * npol + p) * ffts + t, and its sample
// n = m1 * n2 + m2 sits at row m2, lane m1.  Rows m2 >= n2 and lanes
// m1 >= n1 are padding that no sum reads.
template <class T>
struct CtMajor {
  const T* x;
  int npol, ffts, n2;
  __device__ __forceinline__ const T* tile(int p, long long j) const {
    const long long s = j / ffts, t = j - s * ffts;
    return x + (((s * npol + p) * ffts + t) << 14);
  }
  __device__ __forceinline__ float operator()(int p, long long j,
                                              int n) const {
    const int m1 = n / n2, m2 = n - m1 * n2;
    return volt(tile(p, j)[m2 * 128 + m1]);
  }
  // as NaturalU8::frame; neighbouring threads read neighbouring lanes
  __device__ __forceinline__ void frame(int p, long long j, int n1, int n2_,
                                        const uint8_t* keep, int nkurto,
                                        bool masked, float* xs) const {
    const T* src = tile(p, j);
    for (int i = threadIdx.x; i < n1 * n2_; i += blockDim.x) {
      const int m2 = i / n1, m1 = i - m2 * n1;
      const int n = m1 * n2_ + m2;
      float v = volt(src[m2 * 128 + m1]);
      if (masked && !keep[n / nkurto]) v = 0.0f;
      xs[n] = v;
    }
  }
};

__device__ __forceinline__ float dag_ts(float kur, const DagK& k,
                                        float dag_inf) {
  const float den = __fadd_rn(
      1.0f, __fmul_rn(__fsub_rn(__fsub_rn(kur, 3.0f), k.mu1), k.z23));
  const float t = __fdiv_rn(k.c1, den);
  float d = fabsf(__fmul_rn(k.z21, __fsub_rn(k.z22, cbrtf(t))));
  if (!(t > 0.0f)) d = dag_inf;
  if (kur == 0.0f) d = dag_inf;
  return d;
}

struct FrontCounts {
  int nkeep;  // windows kept (both gates passed)
  int nflag;  // windows flagged by the fine gate
};

// Floats of shared memory front_block needs.
template <class Params>
__host__ __device__ inline int front_smem_floats(const Params& P) {
  return 2 * P.npol * P.wpf + P.wpf;
}

// The gates of FFT block j (samples [j*nfft, (j+1)*nfft) of every pol).
// Every thread of the block calls it, with `sm` holding
// front_smem_floats(P) floats.  On return the block is synchronised,
// sm[2*npol*wpf + w] holds the pol-combined fine TS of window w, keep[w]
// its gate (1 = kept), and thread 0 holds the counts (0 elsewhere).
// Params needs npol, nkurto, wpf, rkurto, dag_thresh, dag_fb_thresh,
// dag_inf, kf (fine DagK) and kb (block DagK); Load is a loader above.
template <class Params, class Load>
__device__ FrontCounts front_block(const Params& P, const Load& ld,
                                   long long j, float* sm, uint8_t* keep) {
  float* m2s = sm;                       // (npol, wpf) window power
  float* kus = sm + P.npol * P.wpf;      // (npol, wpf) window kurtosis
  float* dags = kus + P.npol * P.wpf;    // (wpf,) pol-combined fine TS
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int pw = warp; pw < P.npol * P.wpf; pw += nwarp) {
    const int p = pw / P.wpf, w = pw - p * P.wpf;
    float s2 = 0.0f, s4 = 0.0f;
    for (int i = lane; i < P.nkurto; i += 32) {
      const float x = ld(p, j, w * P.nkurto + i);
      const float x2 = __fmul_rn(x, x);
      s2 = __fadd_rn(s2, x2);
      s4 = __fadd_rn(s4, __fmul_rn(x2, x2));
    }
    for (int o = 16; o > 0; o >>= 1) {
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
      s4 = __fadd_rn(s4, __shfl_xor_sync(0xffffffffu, s4, o));
    }
    if (lane == 0) {
      const float m2 = __fmul_rn(s2, P.rkurto);
      const float m4 = __fmul_rn(s4, P.rkurto);
      m2s[pw] = m2;
      kus[pw] = m2 == 0.0f ? 0.0f : __fdiv_rn(m4, __fmul_rn(m2, m2));
    }
  }
  __syncthreads();
  FrontCounts c = {0, 0};
  if (threadIdx.x == 0) {
    for (int w = 0; w < P.wpf; ++w) {
      float d = dag_ts(kus[w], P.kf, P.dag_inf);
      for (int p = 1; p < P.npol; ++p)
        d = fmaxf(d, dag_ts(kus[p * P.wpf + w], P.kf, P.dag_inf));
      dags[w] = d;
      c.nflag += d >= P.dag_thresh;
    }
    // block TS from the windows that passed the fine gate
    float dfb = 0.0f;
    for (int p = 0; p < P.npol; ++p) {
      float wsum = 0.0f, psum = 0.0f, qsum = 0.0f;
      for (int w = 0; w < P.wpf; ++w) {
        const float wt = dags[w] < P.dag_thresh ? 1.0f : 0.0f;
        const float pw = m2s[p * P.wpf + w], q = kus[p * P.wpf + w];
        wsum = __fadd_rn(wsum, wt);
        psum = __fadd_rn(psum, __fmul_rn(wt, pw));
        qsum = __fadd_rn(qsum,
                         __fmul_rn(__fmul_rn(__fmul_rn(wt, q), pw), pw));
      }
      float kblk = 0.0f;
      if (wsum > 0.0f) {
        const float pblk = __fdiv_rn(psum, wsum);
        kblk = __fdiv_rn(__fdiv_rn(qsum, wsum), __fmul_rn(pblk, pblk));
      }
      const float d = dag_ts(kblk, P.kb, P.dag_inf);
      dfb = p == 0 ? d : fmaxf(dfb, d);
    }
    const bool block_ok = P.dag_fb_thresh > 0.0f ? dfb < P.dag_fb_thresh
                                                 : true;
    for (int w = 0; w < P.wpf; ++w) {
      const int k = (dags[w] < P.dag_thresh) && block_ok;
      keep[w] = (uint8_t)k;
      c.nkeep += k;
    }
  }
  __syncthreads();
  return c;
}
