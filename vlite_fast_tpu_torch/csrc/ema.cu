// One-pass EMA bandpass normalization over a whole second, hand-written
// for Hopper (sm_90a).  Called through ctypes from ops/pallas_kernels.py.
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
//
//   ema_kernel           one thread per (pol, channel), walking time;
//   ema_weighted_kernel  the same with per-spectrum weights: w == 0 gives
//                        0, p/w > clip_ratio*bp gives clip_value, and
//                        neither updates the bandpass.
//
// What bounds it: the recurrence is sequential in time, so the
// parallelism is npol x nchan (12.5k threads at production) and each
// thread issues its loads in order: load latency, not bandwidth (the
// chain kernel's ema_kernel reads the same planes at ~150 GB/s).  A
// production second reads its 512 MB plane twice (the seed pass and the
// step pass; the second mostly from L2 for a 32-row tile, 800 KB per
// pol) and writes 512 MB.  The TPU kernel carried the bandpass across
// time tiles of a sequential grid in VMEM scratch; here a thread keeps it
// in a register across its own loop over tiles.  Neighbouring threads take
// neighbouring channels, so each row's loads and stores coalesce, and the
// loops are unrolled so that several loads are in flight per thread.
//
// Arithmetic is unfused (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA
// contraction) and a tile's sum runs in time order, as the plain torch
// version (ops/normalize) computes them: the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct EmaParams {
  long long ntime;  // spectra per pol
  int npol, nchan, tt;
  float scale, oms, rtt;           // s, 1 - s, 1/tt
  float clip_ratio, clip_value;    // weighted kernel only
};

__global__ void __launch_bounds__(64)
    ema_kernel(EmaParams P, const float* __restrict__ power,
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

__global__ void __launch_bounds__(64)
    ema_weighted_kernel(EmaParams P, const float* __restrict__ power,
                        const float* __restrict__ weights,
                        const float* __restrict__ bp_in,
                        float* __restrict__ out, float* __restrict__ bp_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.nchan) return;
  const long long off = (long long)blockIdx.y * P.ntime * P.nchan + c;
  const float* pw = power + off;
  const float* wp = weights + (long long)blockIdx.y * P.ntime;
  float* o = out + off;
  float bp = bp_in[(long long)blockIdx.y * P.nchan + c];
  for (long long t0 = 0; t0 < P.ntime; t0 += P.tt) {
    float sum = 0.0f;
    int ngood = 0;
#pragma unroll 8
    for (int t = 0; t < P.tt; ++t) {
      const float w = wp[t0 + t];
      if (w > 0.0f) {
        sum = __fadd_rn(sum, __fdiv_rn(pw[(t0 + t) * P.nchan], w));
        ++ngood;
      }
    }
    const float seed = ngood > 0 ? __fdiv_rn(sum, (float)ngood) : 1.0f;
    if (bp == 0.0f) bp = seed;
    if (ngood > 0 &&
        (seed > __fmul_rn(5.0f, bp) || seed < __fmul_rn(0.2f, bp)))
      bp = seed;
#pragma unroll 8
    for (int t = 0; t < P.tt; ++t) {
      const long long i = (t0 + t) * P.nchan;
      const float w = wp[t0 + t];
      float v = 0.0f;
      if (w > 0.0f) {
        const float x = __fdiv_rn(pw[i], w);
        if (x > __fmul_rn(bp, P.clip_ratio)) {
          v = P.clip_value;
        } else {
          bp = __fadd_rn(__fmul_rn(P.scale, x), __fmul_rn(P.oms, bp));
          v = __fsub_rn(__fdiv_rn(x, bp), 1.0f);
        }
      }
      o[i] = v;
    }
  }
  bp_out[(long long)blockIdx.y * P.nchan + c] = bp;
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
  ema_kernel<<<dim3((P.nchan + 63) / 64, P.npol), 64, 0,
               (cudaStream_t)stream>>>(P, (const float*)power,
                                       (const float*)bp_in, (float*)out,
                                       (float*)bp_out);
  return (int)cudaGetLastError();
}

extern "C" int vf_ema_weighted(const long long* ip, const float* fp,
                               const void* power, const void* weights,
                               const void* bp_in, void* out, void* bp_out,
                               void* stream) {
  const EmaParams P = params(ip, fp);
  ema_weighted_kernel<<<dim3((P.nchan + 63) / 64, P.npol), 64, 0,
                        (cudaStream_t)stream>>>(
      P, (const float*)power, (const float*)weights, (const float*)bp_in,
      (float*)out, (float*)bp_out);
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
