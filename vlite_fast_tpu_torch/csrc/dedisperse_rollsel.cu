// Two-stage subband dedispersion in the roll+select engine's order of sums,
// hand-written for Hopper (sm_90a).  Called through ctypes from
// ops/dedisperse_pallas.py:dedisperse_pallas_rollsel.
//
// Replaces the TPU kernel vlite_fast_tpu/ops/dedisperse_pallas.py:
// dedisperse_pallas_rollsel (bodies _stage1_kernel and _stage2_kernel).
// Same function and the same adds in the same order as the port's
// dedisperse_rollsel_plain:
//
//   fbz       = fb * chan_weights, zero past ntime
//   stage 1:  y[b, s, t] = ((0 + fbz[t + rel[b, c0], c0]) + ...) over the
//             subband's w channels c in order, t < t1_len = ntime_out +
//             max_sub_delay
//   stage 2:  out[d, t] = sum over chunks of sc subbands, in order, of the
//             chunk's own sum from zero, the subbands in order:
//             y[d / per_batch, s, t + sub_delays[d, s]]
//
// What bounds it: the adds and the loads that feed them.  At the
// production gulp (4096 channels, 128 batches, 4864 trials) stage 1 is
// ~11.5 G adds and stage 2 ~9.6 G, each fed by a load; the filterbank
// (~0.44 GB) and the output (~0.3 GB) are small beside that.  The TPU
// kernel's point is that a subband's filterbank block is fetched once and
// reused by every DM batch; C1 keeps it: a block stages one subband's w
// channels for a time tile plus the in-subband delay halo in shared
// memory, read straight from the time-major filterbank (w channels of a
// row are contiguous, so no transposed copy), then loops over all nbatch
// batches from there.  The tile's row stride is odd, so the 32 threads of
// a warp (consecutive t, one channel) hit 32 banks.  C2 gives each thread
// one time sample and up to kTrials trials of a batch in registers, so the
// batch's stage-1 rows are read once per group of trials (through L1).
// Later work: stage 2 from shared memory, and stage 1 with several
// samples per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTrials = 8;               // trials per thread in C2
constexpr int kTileFloats = 16384;       // a C1 tile: rows x w ~ 64 KB
constexpr size_t kSmemMax = 232448;      // a block's shared memory on sm_90

struct S1Geom {
  int T;        // samples per tile
  int rows;     // T + halo
  int stride;   // row stride in floats (odd)
  size_t smem;
};

S1Geom stage1_geom(int w, int nbatch, int halo) {
  S1Geom g;
  g.stride = w | 1;
  g.T = kTileFloats / w;
  g.T = g.T < 32 ? 32 : g.T - g.T % 32;
  for (;;) {
    g.rows = g.T + halo;
    g.smem = ((size_t)g.rows * g.stride + (size_t)nbatch * w) * 4;
    if (g.smem <= kSmemMax || g.T <= 32) break;
    g.T -= 32;
  }
  return g;
}

// grid (time tiles, nsub), kThreads threads
__global__ void rollsel_stage1(const float* __restrict__ fb, int ntime,
                               int nchan, const float* __restrict__ cw,
                               const int* __restrict__ rel, int nbatch,
                               int nsub, int w, int t1_len, S1Geom G,
                               float* __restrict__ y) {
  extern __shared__ float sm[];
  float* tile = sm;                                   // (rows, stride)
  int* rs = (int*)(sm + (size_t)G.rows * G.stride);   // (nbatch, w)
  const int s = blockIdx.y, c0 = s * w;
  const int t0 = blockIdx.x * G.T;
  for (int i = threadIdx.x; i < nbatch * w; i += blockDim.x) {
    const int b = i / w, c = i - b * w;
    rs[i] = rel[(long long)b * nchan + c0 + c];
  }
  for (int i = threadIdx.x; i < G.rows * w; i += blockDim.x) {
    const int r = i / w, c = i - r * w;
    const long long t = (long long)t0 + r;
    tile[r * G.stride + c] =
        t < ntime ? __fmul_rn(fb[t * nchan + c0 + c], cw[c0 + c]) : 0.0f;
  }
  __syncthreads();
  const int nt = min(G.T, t1_len - t0);
  for (int b = 0; b < nbatch; ++b) {
    const int* rb = rs + b * w;
    float* yo = y + ((long long)b * nsub + s) * t1_len + t0;
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int c = 0; c < w; ++c)
        acc = __fadd_rn(acc, tile[(i + rb[c]) * G.stride + c]);
      yo[i] = acc;
    }
  }
}

// grid (time tiles of kThreads, trial groups, nbatch), kThreads threads
__global__ void rollsel_stage2(const float* __restrict__ y, int nsub,
                               int t1_len, const int* __restrict__ subd,
                               int per_batch, int sc, int ntime_out,
                               float* __restrict__ out) {
  extern __shared__ int sd[];                         // (kTrials, nsub)
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kTrials;
  const int nk = min(kTrials, per_batch - k0);
  const long long d0 = (long long)b * per_batch + k0;
  for (int i = threadIdx.x; i < nk * nsub; i += blockDim.x)
    sd[i] = subd[d0 * nsub + i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntime_out) return;
  const float* yb = y + (long long)b * nsub * t1_len + t;
  float tot[kTrials];
#pragma unroll
  for (int k = 0; k < kTrials; ++k) tot[k] = 0.0f;
  for (int s0 = 0; s0 < nsub; s0 += sc) {
    float acc[kTrials];
#pragma unroll
    for (int k = 0; k < kTrials; ++k) acc[k] = 0.0f;
    for (int s = s0; s < s0 + sc; ++s) {
      const float* row = yb + (long long)s * t1_len;
#pragma unroll
      for (int k = 0; k < kTrials; ++k)
        if (k < nk) acc[k] = __fadd_rn(acc[k], __ldg(row + sd[k * nsub + s]));
    }
#pragma unroll
    for (int k = 0; k < kTrials; ++k) tot[k] = __fadd_rn(tot[k], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < kTrials; ++k)
    if (k < nk) out[(d0 + k) * ntime_out + t] = tot[k];
}

}  // namespace

// C1.  fb f32 (ntime, nchan) time-major, unzapped; cw f32 (nchan,) the zap
// weights; rel i32 (nbatch, nchan), 0 <= rel <= halo; y f32 (nbatch, nsub,
// t1_len) out.  Returns cudaGetLastError().
extern "C" int vf_rollsel_stage1(const void* fb, int ntime, int nchan,
                                 const void* cw, const void* rel, int nbatch,
                                 int nsub, int halo, int t1_len, void* y,
                                 void* stream) {
  const int w = nchan / nsub;
  const S1Geom G = stage1_geom(w, nbatch, halo);
  if (G.smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rollsel_stage1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G.smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t1_len + G.T - 1) / G.T, nsub);
  rollsel_stage1<<<grid, kThreads, G.smem, (cudaStream_t)stream>>>(
      (const float*)fb, ntime, nchan, (const float*)cw, (const int*)rel,
      nbatch, nsub, w, t1_len, G, (float*)y);
  return (int)cudaGetLastError();
}

// C2.  y f32 (nbatch, nsub, t1_len); sub_delays i32 (nbatch * per_batch,
// nsub) with every t + delay < t1_len, trial d in batch d / per_batch; sc
// divides nsub; out f32 (ndm, ntime_out).  Returns cudaGetLastError().
extern "C" int vf_rollsel_stage2(const void* y, int nsub, int t1_len,
                                 const void* sub_delays, int nbatch,
                                 int per_batch, int sc, int ntime_out,
                                 void* out, void* stream) {
  if (sc < 1 || nsub % sc) return (int)cudaErrorInvalidValue;
  dim3 grid((ntime_out + kThreads - 1) / kThreads,
            (per_batch + kTrials - 1) / kTrials, nbatch);
  rollsel_stage2<<<grid, kThreads, kTrials * nsub * sizeof(int),
                   (cudaStream_t)stream>>>(
      (const float*)y, nsub, t1_len, (const int*)sub_delays, per_batch, sc,
      ntime_out, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
