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
// Both run the two-phase EMA of chain.cuh on one stream of it: the
// unweighted kernel on its plain stream 0, the weighted one on its
// weighted stream 1, each on the one plane it is given:
//   seed_kernel      (only where a tile is longer than the walk's
//                    32-spectrum chunk) each tile's seed and, weighted,
//                    count of good spectra, one thread per (pol, tile,
//                    channel);
//   bandpass_kernel  the recurrence alone, one thread per (pol, channel),
//                    fed by a ring of cp.async chunks in shared memory;
//                    per tile the seed (from the chunk where the tile fits
//                    one), the reseed and, weighted, the stale test, and
//                    the bandpass the tile starts from;
//   ema_out_kernel   one thread per (tile, pol, channel), ~4M at
//                    production: from the tile's starting bandpass the
//                    same steps again (chain.cuh's ema_step) and the
//                    normalized (weighted: clipped) output, its loads
//                    independent across spectra.
// Only the recurrence is sequential, so it runs alone: a walk that also
// normalized each spectrum would pay that work's latency at ~3 warps per
// SM.
//
// Arithmetic is unfused (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA
// contraction) and a tile's sum runs in time order, as the plain torch
// version (ops/normalize) computes them: the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int kOutThreads = 128;
constexpr int kOutChunk = 8;     // spectra loaded ahead per thread

// Phase 3 on stream s: one thread per (tile, pol, channel).  The tile's
// starting bandpass comes from bandpass_kernel; the steps are ema_step's,
// so the bandpass is the walk's bit for bit.
template <int s>
__global__ void __launch_bounds__(kOutThreads)
    ema_out_kernel(ChainParams P, const float* __restrict__ power,
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
  float* o = out + off;
  for (int u0 = 0; u0 < P.ffts; u0 += kOutChunk) {
    float v[kOutChunk], w[kOutChunk];
#pragma unroll
    for (int u = 0; u < kOutChunk; ++u) {
      v[u] = w[u] = 0.0f;
      if (u0 + u < P.ffts) {
        v[u] = __ldg(pw + (long long)(u0 + u) * P.nchan);
        // the unweighted launch has no weights (nullptr)
        if (s == 1)
          w[u] = __ldg(weights + (long long)p * P.nblk + t0 + u0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < kOutChunk; ++u) {
      if (u0 + u < P.ffts) {
        const bool good = s == 0 || w[u] > 0.0f;
        const float x = ema_x<s>(v[u], w[u]);
        const bool clipped = ema_step<s>(P, x, good, bp);
        o[(long long)(u0 + u) * P.nchan] =
            good ? (clipped ? P.clip_value : __fsub_rn(__fdiv_rn(x, bp), 1.0f))
                 : 0.0f;
      }
    }
  }
}

// ip (int64): npol, ntime, nchan, tt; fp (f32): scale, 1 - scale, 1/tt,
// clip_ratio, clip_value
ChainParams params(const long long* ip, const float* fp) {
  ChainParams P = {};
  P.npol = (int)ip[0];
  P.nblk = (int)ip[1];
  P.nchan = (int)ip[2];
  P.ffts = (int)ip[3];
  P.nseg = P.nblk / P.ffts;
  P.scale = fp[0];
  P.oms = fp[1];
  P.rffts = fp[2];
  P.clip_ratio = fp[3];
  P.clip_value = fp[4];
  return P;
}

// Stream s of chain.cuh's EMA over one plane.  chain.cuh's kernels index
// the bandpass and the seeds by stream, so stream s gets these arrays
// shifted back by s streams' share.
template <int s>
int launch(const long long* ip, const float* fp, const void* power,
           const void* weights, const void* bp_in, void* out, void* bp_out,
           void* seeds, void* stream) {
  const ChainParams P = params(ip, fp);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* pw = (const float*)power;
  const float* w = (const float*)weights;
  float* sd = (float*)seeds - (long long)s * P.npol * P.nseg * P.nchan;
  const float* bi = (const float*)bp_in - (long long)s * P.npol * P.nchan;
  float* bo = (float*)bp_out - (long long)s * P.npol * P.nchan;
  cudaError_t e;
  if (P.ffts > kBpChunk) {
    seed_kernel<<<dim3((P.nchan + kSeedThreads - 1) / kSeedThreads, P.nseg,
                       P.npol),
                  kSeedThreads, 0, st>>>(P, s, pw, pw, nullptr, w, sd);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  bandpass_kernel<<<dim3((P.nchan + kBpThreads - 1) / kBpThreads, P.npol, 1),
                    kBpThreads, 0, st>>>(P, s, pw, pw, nullptr, w, sd, bi,
                                         bo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ema_out_kernel<s><<<dim3((P.nchan + kOutThreads - 1) / kOutThreads,
                           P.nseg, P.npol),
                      kOutThreads, 0, st>>>(P, pw, w, (const float*)seeds,
                                            (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// ip (int64): npol, ntime, nchan, tt (tt divides ntime)
// fp (f32):   scale, 1 - scale, 1/tt, clip_ratio, clip_value
// Device pointers: power / out f32 (npol, ntime, nchan); weights f32
// (npol, ntime); bp_in / bp_out f32 (npol, nchan); seeds: scratch of
// npol * (ntime / tt) * nchan f32 + npol * (ntime / tt) i32 (each tile's
// seed, then the bandpass it starts from; weighted, the counts of good
// spectra).  Each launches on `stream` and returns cudaGetLastError()
// after its launches.
extern "C" int vf_ema(const long long* ip, const float* fp, const void* power,
                      const void* bp_in, void* out, void* bp_out, void* seeds,
                      void* stream) {
  return launch<0>(ip, fp, power, nullptr, bp_in, out, bp_out, seeds, stream);
}

extern "C" int vf_ema_weighted(const long long* ip, const float* fp,
                               const void* power, const void* weights,
                               const void* bp_in, void* out, void* bp_out,
                               void* seeds, void* stream) {
  return launch<1>(ip, fp, power, weights, bp_in, out, bp_out, seeds, stream);
}
