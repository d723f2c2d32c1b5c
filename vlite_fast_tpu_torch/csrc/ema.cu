// Bandpass normalization over a whole second, hand-written for Hopper
// (sm_90a).  Called through ctypes from ops/pallas_kernels.py.
//
// Replaces the TPU kernels vlite_fast_tpu/ops/pallas_kernels.py:
//   normalize_ema_pallas           (body _ema_kernel)
//   normalize_ema_weighted_pallas  (body _ema_weighted_kernel)
// Power (npol, ntime, nchan) f32 in, p/bp - 1 out, the bandpass (npol,
// nchan) carried.  Time is cut into tiles of tt spectra; each tile seeds
// a zero bandpass from its own mean (1 if that mean is 0) and, weighted,
// re-seeds a stale one (tile mean more than 5x off), then the recurrence
// bp = s*p + (1-s)*bp runs through the tile's spectra in order.  With
// tt = ffts_per_seg that is the per-segment call sequence of the chain.
// Weighted, a spectrum counts where w > 0, at x = p / w: w == 0 gives 0,
// x > clip_ratio*bp gives clip_value, and neither updates the bandpass.
//
// What bounds them: bytes.  A production second reads its 512 MB plane
// and writes 512 MB (0.31 ms at 3.35 TB/s); the recurrence leaves only
// npol x nchan (12.5k) sequential walks.
//
//   normalize_ema_pallas: ema_onepass_kernel, one thread per (pol,
//     channel) walking time, the bandpass in a register across the tiles
//     (the seed pass and the step pass each read the tile); load latency
//     at ~3 warps per SM bounds it.
//   normalize_ema_weighted_pallas: the two-phase EMA of chain.cuh, on one
//     stream (its weighted stream 1, on the one plane):
//     seed_kernel        (only where a tile is longer than the walk's
//                        32-spectrum chunk) each tile's seed and count of
//                        good spectra, one thread per (pol, tile, channel);
//     bandpass_kernel    the recurrence alone, one thread per (pol,
//                        channel), fed by a ring of cp.async chunks in
//                        shared memory; per tile the seed (from the chunk
//                        where the tile fits one), the reseed and stale
//                        test, and the bandpass the tile starts from;
//     ema_weighted_out_kernel  one thread per (tile, pol, channel), ~4M at
//                        production: from the tile's starting bandpass the
//                        same steps again (chain.cuh's ema_step) and the
//                        normalized, clipped output, its loads independent
//                        across spectra.
//     The one-thread walk that did it all (a divide and a branch per
//     spectrum at ~3 warps per SM) took 6.45 ms per production second
//     (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Arithmetic is unfused (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA
// contraction) and a tile's sum runs in time order, as the plain torch
// version (ops/normalize) computes them: the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

struct EmaParams {
  long long ntime;  // spectra per pol
  int npol, nchan, tt;
  float scale, oms, rtt;           // s, 1 - s, 1/tt
  float clip_ratio, clip_value;    // weighted kernel only
};

__global__ void __launch_bounds__(64)
    ema_onepass_kernel(EmaParams P, const float* __restrict__ power,
               const float* __restrict__ bp_in, float* __restrict__ out,
               float* __restrict__ bp_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.nchan) return;
  const long long off = (long long)blockIdx.y * P.ntime * P.nchan + c;
  const float* pw = power + off;
  float* o = out + off;
  float bp = bp_in[(long long)blockIdx.y * P.nchan + c];
  for (long long t0 = 0; t0 < P.ntime; t0 += P.tt) {
    float sum = 0.0f;
#pragma unroll 8
    for (int t = 0; t < P.tt; ++t)
      sum = __fadd_rn(sum, pw[(t0 + t) * P.nchan]);
    float seed = __fmul_rn(sum, P.rtt);
    if (seed == 0.0f) seed = 1.0f;
    if (bp == 0.0f) bp = seed;
#pragma unroll 8
    for (int t = 0; t < P.tt; ++t) {
      const long long i = (t0 + t) * P.nchan;
      const float v = pw[i];
      bp = __fadd_rn(__fmul_rn(P.scale, v), __fmul_rn(P.oms, bp));
      o[i] = __fsub_rn(__fdiv_rn(v, bp), 1.0f);
    }
  }
  bp_out[(long long)blockIdx.y * P.nchan + c] = bp;
}

constexpr int kOutThreads = 128;
constexpr int kOutChunk = 8;     // spectra loaded ahead per thread

// Phase 3: one thread per (tile, pol, channel).  The tile's starting
// bandpass comes from bandpass_kernel; the steps are ema_step's, so the
// bandpass is the walk's bit for bit.
__global__ void __launch_bounds__(kOutThreads)
    ema_weighted_out_kernel(ChainParams P, const float* __restrict__ power,
                            const float* __restrict__ weights,
                            const float* __restrict__ starts,
                            float* __restrict__ out) {
  const int c = blockIdx.x * kOutThreads + threadIdx.x;
  const int seg = blockIdx.y, p = blockIdx.z;
  if (c >= P.nchan) return;
  float bp = starts[((long long)p * P.nseg + seg) * P.nchan + c];
  const long long t0 = (long long)seg * P.ffts;
  const long long off = ((long long)p * P.nblk + t0) * P.nchan + c;
  const float* pw = power + off;
  const float* wp = weights + (long long)p * P.nblk + t0;
  float* o = out + off;
  for (int u0 = 0; u0 < P.ffts; u0 += kOutChunk) {
    float v[kOutChunk], w[kOutChunk];
#pragma unroll
    for (int u = 0; u < kOutChunk; ++u) {
      v[u] = w[u] = 0.0f;
      if (u0 + u < P.ffts) {
        v[u] = __ldg(pw + (long long)(u0 + u) * P.nchan);
        w[u] = __ldg(wp + u0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < kOutChunk; ++u) {
      if (u0 + u < P.ffts) {
        const bool good = w[u] > 0.0f;
        const float x = ema_x<1>(v[u], w[u]);
        const bool clipped = ema_step<1>(P, x, good, bp);
        o[(long long)(u0 + u) * P.nchan] =
            good ? (clipped ? P.clip_value : __fsub_rn(__fdiv_rn(x, bp), 1.0f))
                 : 0.0f;
      }
    }
  }
}

EmaParams params(const long long* ip, const float* fp) {
  EmaParams P;
  P.npol = (int)ip[0];
  P.ntime = ip[1];
  P.nchan = (int)ip[2];
  P.tt = (int)ip[3];
  P.scale = fp[0];
  P.oms = fp[1];
  P.rtt = fp[2];
  P.clip_ratio = fp[3];
  P.clip_value = fp[4];
  return P;
}

}  // namespace

// ip (int64): npol, ntime, nchan, tt (tt divides ntime)
// fp (f32):   scale, 1 - scale, 1/tt, clip_ratio, clip_value
// Device pointers: power / out f32 (npol, ntime, nchan); weights f32
// (npol, ntime); bp_in / bp_out f32 (npol, nchan).
// Each launches on `stream` and returns cudaGetLastError() after it.
extern "C" int vf_ema(const long long* ip, const float* fp, const void* power,
                      const void* bp_in, void* out, void* bp_out,
                      void* stream) {
  const EmaParams P = params(ip, fp);
  ema_onepass_kernel<<<dim3((P.nchan + 63) / 64, P.npol), 64, 0,
               (cudaStream_t)stream>>>(P, (const float*)power,
                                       (const float*)bp_in, (float*)out,
                                       (float*)bp_out);
  return (int)cudaGetLastError();
}

// seeds: scratch of npol * (ntime / tt) * nchan f32 + npol * (ntime / tt)
// i32 (each tile's seed, then the bandpass it starts from; the counts of
// good spectra).
extern "C" int vf_ema_weighted(const long long* ip, const float* fp,
                               const void* power, const void* weights,
                               const void* bp_in, void* out, void* bp_out,
                               void* seeds, void* stream) {
  const EmaParams E = params(ip, fp);
  ChainParams P = {};
  P.npol = E.npol;
  P.nchan = E.nchan;
  P.nblk = (int)E.ntime;
  P.ffts = E.tt;
  P.nseg = (int)(E.ntime / E.tt);
  P.scale = E.scale;
  P.oms = E.oms;
  P.rffts = E.rtt;
  P.clip_ratio = E.clip_ratio;
  P.clip_value = E.clip_value;
  const cudaStream_t st = (cudaStream_t)stream;
  // chain.cuh's kernels index the bandpass and the seeds by stream; the
  // weighted stream is stream 1, so they get these arrays shifted back by
  // one stream's share
  float* sd = (float*)seeds - (long long)P.npol * P.nseg * P.nchan;
  const float* bi = (const float*)bp_in - (long long)P.npol * P.nchan;
  float* bo = (float*)bp_out - (long long)P.npol * P.nchan;
  cudaError_t e;
  if (P.ffts > kBpChunk) {
    seed_kernel<<<dim3((P.nchan + kSeedThreads - 1) / kSeedThreads, P.nseg,
                       P.npol),
                  kSeedThreads, 0, st>>>(P, 1, (const float*)power,
                                         (const float*)power, nullptr,
                                         (const float*)weights, sd);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  bandpass_kernel<<<dim3((P.nchan + kBpThreads - 1) / kBpThreads, P.npol, 1),
                    kBpThreads, 0, st>>>(
      P, 1, (const float*)power, (const float*)power, nullptr,
      (const float*)weights, sd, bi, bo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ema_weighted_out_kernel<<<dim3((P.nchan + kOutThreads - 1) / kOutThreads,
                                 P.nseg, P.npol),
                            kOutThreads, 0, st>>>(
      P, (const float*)power, (const float*)weights, (const float*)seeds,
      (float*)out);
  return (int)cudaGetLastError();
}
