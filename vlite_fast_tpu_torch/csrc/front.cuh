// The spectral-kurtosis RFI front of one FFT block, shared by the chain
// kernels (chain.cuh, front_kernel) and the armed program's front
// (rfi_front.cu).  Same statistics as the port's ops/kurtosis.rfi_excise
// and the JAX package's ops/rfi_pallas._front_kernel: convert, m2 and m4
// per nkurto window, the D'Agostino TS pol-combined by max, the block TS
// over the windows that passed the fine gate, and the two gates.  Two
// steps: window_stats (one warp per (pol, window)), then block_gates on
// one warp (a lane per window for the fine TS, a lane per pol for the
// block TS); front_block runs both.
//
// Arithmetic uses the unfused __fmul_rn / __fadd_rn so the gates round as
// the plain torch version and the JAX reference do (no contraction into
// FMA); means are sum * (1/n), the form XLA gives jnp.mean.
//
// The voltages reach the front through a loader: ld(p, j, n) is sample n
// of FFT block j of pol p, converted.  NaturalU8 reads the raw second,
// chain.cuh's StagedFrames the samples of CtMajor tiles (the
// Cooley-Tukey-major layout of ops/megakernel.pallas_pretranspose) staged
// in frame order, and rfi_front.cu's StagedU8 the block's bytes it staged
// in shared memory.  Every layout sums the same samples in the same order,
// so the statistics are bit-equal across layouts.  NaturalU8 and CtMajor
// are also dft_tc.cuh's loaders.
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
};

// Cooley-Tukey-major tiles, (nseg, npol * ffts * 128, 128) of T (u8 raw
// bytes or bf16 converted voltages): block j = s * ffts + t of pol p is
// the 128 x 128 tile number (s * npol + p) * ffts + t, and its sample
// n = m1 * n2 + m2 sits at row m2, lane m1.  Rows m2 >= n2 and lanes
// m1 >= n1 are padding that no sum reads.
template <class T>
struct CtMajor {
  const T* x;
  int npol, ffts;
  // the offset of the tile's first element in x
  __device__ __forceinline__ long long tile(long long p, long long j) const {
    const long long s = j / ffts, t = j - s * ffts;
    return ((s * npol + p) * ffts + t) << 14;
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

// The window statistics of FFT block j: one warp per (pol, window), lane
// l summing samples l, l + 32, ... in order, then a shuffle tree.  Every
// thread of the block calls it; sm gets m2 (npol, wpf) then the kurtosis
// (npol, wpf).
template <class Params, class Load>
__device__ __forceinline__ void window_stats(const Params& P, const Load& ld,
                                             long long j, float* sm) {
  float* m2s = sm;                       // (npol, wpf) window power
  float* kus = sm + P.npol * P.wpf;      // (npol, wpf) window kurtosis
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
}

// The gates from window_stats' sm, on warp 0 (the other warps return at
// once): lane w (and w + 32, ...) the pol-combined fine TS of window w
// into sm[2*npol*wpf + w]; lane p the block TS of pol p over the windows
// that passed the fine gate, summed in window order; then keep[w] (1 =
// kept).  Lane 0 (thread 0) returns the counts, 0 elsewhere.  The
// arithmetic and its order are those of one thread walking the windows.
template <class Params>
__device__ __forceinline__ FrontCounts block_gates(const Params& P, float* sm,
                                                   uint8_t* keep) {
  const float* m2s = sm;
  const float* kus = sm + P.npol * P.wpf;
  float* dags = sm + 2 * P.npol * P.wpf;
  FrontCounts c = {0, 0};
  if (threadIdx.x >= 32) return c;
  const int lane = threadIdx.x;
  for (int w0 = 0; w0 < P.wpf; w0 += 32) {
    const int w = w0 + lane;
    bool flag = false;
    if (w < P.wpf) {
      float d = dag_ts(kus[w], P.kf, P.dag_inf);
      for (int p = 1; p < P.npol; ++p)
        d = fmaxf(d, dag_ts(kus[p * P.wpf + w], P.kf, P.dag_inf));
      dags[w] = d;
      flag = d >= P.dag_thresh;
    }
    c.nflag += __popc(__ballot_sync(0xffffffffu, flag));
  }
  __syncwarp();
  // block TS from the windows that passed the fine gate, lane p for pol p
  float d = 0.0f;
  if (lane < P.npol) {
    float wsum = 0.0f, psum = 0.0f, qsum = 0.0f;
    for (int w = 0; w < P.wpf; ++w) {
      const float wt = dags[w] < P.dag_thresh ? 1.0f : 0.0f;
      const float pw = m2s[lane * P.wpf + w], q = kus[lane * P.wpf + w];
      wsum = __fadd_rn(wsum, wt);
      psum = __fadd_rn(psum, __fmul_rn(wt, pw));
      qsum = __fadd_rn(qsum, __fmul_rn(__fmul_rn(__fmul_rn(wt, q), pw), pw));
    }
    float kblk = 0.0f;
    if (wsum > 0.0f) {
      const float pblk = __fdiv_rn(psum, wsum);
      kblk = __fdiv_rn(__fdiv_rn(qsum, wsum), __fmul_rn(pblk, pblk));
    }
    d = dag_ts(kblk, P.kb, P.dag_inf);
  }
  float dfb = __shfl_sync(0xffffffffu, d, 0);
  for (int p = 1; p < P.npol; ++p)
    dfb = fmaxf(dfb, __shfl_sync(0xffffffffu, d, p));
  const bool block_ok = P.dag_fb_thresh > 0.0f ? dfb < P.dag_fb_thresh
                                               : true;
  for (int w0 = 0; w0 < P.wpf; w0 += 32) {
    const int w = w0 + lane;
    const bool k = w < P.wpf && dags[w] < P.dag_thresh && block_ok;
    if (w < P.wpf) keep[w] = (uint8_t)k;
    c.nkeep += __popc(__ballot_sync(0xffffffffu, k));
  }
  if (lane != 0) c = FrontCounts{0, 0};
  return c;
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
  window_stats(P, ld, j, sm);
  __syncthreads();
  const FrontCounts c = block_gates(P, sm, keep);
  __syncthreads();
  return c;
}
