// The front and the back end of the fused chain, shared by the two chain
// sources: chain.cu (one block per frame for the DFT; the natural and the
// Cooley-Tukey-major input layouts) and chain_v4.cu (the DFT as two
// batched passes).  Between them each source writes the power planes.
//
//   front_kernel  one block per FFT block (both pols): the statistics and
//                 gates of front.cuh, the keep flag per window, the weight
//                 per (pol, block), the flagged-window count per segment.
//   ema_kernel    one thread per (stream, channel), both pols, walking the
//                 second's spectra in order: per-segment seeding (plus
//                 stale recovery and clipping on the weighted stream),
//                 pscrunch, tscrunch, 2-bit thresholds, and the pack of 4
//                 channels per byte by warp shuffles, written straight as
//                 sel_and_dig rows.
//
// Arithmetic in the front and the EMA uses the unfused __fmul_rn /
// __fadd_rn so the gates and the bandpass round as the plain torch
// version and the JAX reference do (no contraction into FMA).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "front.cuh"

namespace {

struct ChainParams {
  long long nsamp;  // samples per pol in the second
  int npol, nfft, n1, n2, n2_out, nchan, nkurto, wpf, ffts, nseg, nscrunch;
  int nblk;         // FFT blocks per pol in the second (nseg * ffts)
  int chanmin, chanmax, nbytes, pad, rfi_mode;
  float scale, oms, dag_thresh, dag_fb_thresh, dag_inf, clip_ratio,
      clip_value, min_weight, sqrt_half, inv_sqrt_ns, q0, q1, q2;
  // 1/n for the means over n (sum * 1/n, the form XLA gives jnp.mean)
  float rkurto, rwpf, rwin, rffts, rns;
  DagK kf, kb;
};

// ip (int64): npol, nsamp, nfft, n1, n2, nkurto, seg_per_sec, nscrunch,
//             rfi_mode, chanmin, chanmax
// fp (f32):   scale, oms, dag_thresh, dag_fb_thresh, dag_inf, clip_ratio,
//             clip_value, min_weight, sqrt_half, inv_sqrt_ns, q0, q1, q2,
//             kf[5], kb[5]   (DagK order: c1, mu1, z21, z22, z23)
ChainParams chain_params(const long long* ip, const float* fp) {
  ChainParams P;
  P.npol = (int)ip[0];
  P.nsamp = ip[1];
  P.nfft = (int)ip[2];
  P.n1 = (int)ip[3];
  P.n2 = (int)ip[4];
  P.nkurto = (int)ip[5];
  P.nseg = (int)ip[6];
  P.nscrunch = (int)ip[7];
  P.rfi_mode = (int)ip[8];
  P.chanmin = (int)ip[9];
  P.chanmax = (int)ip[10];
  P.n2_out = P.nfft / 2 / P.n1 + 1;
  P.nchan = P.nfft / 2 + 1;
  P.wpf = P.nfft / P.nkurto;
  P.ffts = (int)(P.nsamp / P.nseg / P.nfft);
  P.nblk = P.nseg * P.ffts;
  P.nbytes = (P.chanmax - P.chanmin + 1) / 4;
  P.pad = (4 - P.chanmin % 4) % 4;
  P.scale = fp[0];
  P.oms = fp[1];
  P.dag_thresh = fp[2];
  P.dag_fb_thresh = fp[3];
  P.dag_inf = fp[4];
  P.clip_ratio = fp[5];
  P.clip_value = fp[6];
  P.min_weight = fp[7];
  P.sqrt_half = fp[8];
  P.inv_sqrt_ns = fp[9];
  P.q0 = fp[10];
  P.q1 = fp[11];
  P.q2 = fp[12];
  P.kf = DagK{fp[13], fp[14], fp[15], fp[16], fp[17]};
  P.kb = DagK{fp[18], fp[19], fp[20], fp[21], fp[22]};
  P.rkurto = 1.0f / (float)P.nkurto;
  P.rwpf = 1.0f / (float)P.wpf;
  P.rwin = 1.0f / (float)(P.ffts * P.wpf);
  P.rffts = 1.0f / (float)P.ffts;
  P.rns = 1.0f / (float)P.nscrunch;
  return P;
}

// the first stream a launch computes (0 plain, 1 weighted) and how many
inline int first_stream(const ChainParams& P) {
  return P.rfi_mode == 1 ? 1 : 0;
}
inline int num_streams(const ChainParams& P) {
  return P.rfi_mode == 2 ? 2 : 1;
}

template <class Load>
__global__ void front_kernel(ChainParams P, Load ld,
                             uint8_t* __restrict__ keep,
                             float* __restrict__ weights,
                             int* __restrict__ dagcnt) {
  extern __shared__ float sm[];
  const int j = blockIdx.x;
  const FrontCounts c =
      front_block(P, ld, j, sm, keep + (long long)j * P.wpf);
  if (threadIdx.x != 0) return;
  const float wt = __fmul_rn((float)c.nkeep, P.rwpf);
  for (int p = 0; p < P.npol; ++p) weights[(long long)p * P.nblk + j] = wt;
  atomicAdd(&dagcnt[j / P.ffts], c.nflag);
}

__device__ __forceinline__ void emit(const ChainParams& P, float v,
                                     int row, int c, int lane,
                                     uint8_t* __restrict__ out) {
  const bool in = c >= P.chanmin && c <= P.chanmax;
  const unsigned lev = (v >= P.q0) + (v >= P.q1) + (v >= P.q2);
  unsigned b = in ? lev << (2 * (lane & 3)) : 0u;
  b |= __shfl_xor_sync(0xffffffffu, b, 1);
  b |= __shfl_xor_sync(0xffffffffu, b, 2);
  if (in && (lane & 3) == 0)
    out[(long long)row * P.nbytes + (c - P.chanmin) / 4] = (uint8_t)b;
}

// a loop over the (at most two) pols with compile-time indices, so the
// per-pol state stays in registers
#define PER_POL(p) \
  _Pragma("unroll") for (int p = 0; p < 2; ++p) if (p < P.npol)

// power: f32 (nstreams, npol, nblk, nchan), the streams the launch
// computes from first_stream(P) on
__global__ void ema_kernel(ChainParams P, int stream0,
                           const float* __restrict__ power,
                           const float* __restrict__ weights,
                           const float* __restrict__ bp_in,
                           float* __restrict__ bp_out,
                           uint8_t* __restrict__ packed,
                           uint8_t* __restrict__ packed_kur,
                           const int* __restrict__ dagcnt,
                           float* __restrict__ dag_frac) {
  const int s = stream0 + blockIdx.y;    // 0 plain, 1 weighted
  // thread -> channel with (c - chanmin) % 4 == lane % 4, so four
  // neighbouring lanes hold the four channels of one output byte
  const int c = blockIdx.x * blockDim.x + threadIdx.x - P.pad;
  const int lane = threadIdx.x & 31;
  const bool valid = c >= 0 && c < P.nchan;
  const int cl = min(max(c, 0), P.nchan - 1);
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int k = threadIdx.x; k < P.nseg; k += blockDim.x)
      dag_frac[k] = __fmul_rn((float)dagcnt[k], P.rwin);
  const long long pstride = (long long)P.nblk * P.nchan;   // per pol
  const float* pw = power + (long long)blockIdx.y * P.npol * pstride + cl;
  float bp[2] = {0.0f, 0.0f};
  PER_POL(p)
    bp[p] = bp_in[((long long)s * P.npol + p) * P.nchan + cl];
  uint8_t* out = s == 0 ? packed : packed_kur;
  const int nout = P.ffts / P.nscrunch;
  for (int seg = 0; seg < P.nseg; ++seg) {
    const int t0 = seg * P.ffts;
    if (s == 0) {
      PER_POL(p) {
        float sum = 0.0f;
#pragma unroll 8
        for (int t = 0; t < P.ffts; ++t)
          sum = __fadd_rn(sum,
                          pw[p * pstride + (long long)(t0 + t) * P.nchan]);
        float seed = __fmul_rn(sum, P.rffts);
        if (seed == 0.0f) seed = 1.0f;
        if (bp[p] == 0.0f) bp[p] = seed;
      }
      for (int o = 0; o < nout; ++o) {
        float acc = 0.0f;
        for (int q = 0; q < P.nscrunch; ++q) {
          const long long t = t0 + o * P.nscrunch + q;
          float op[2] = {0.0f, 0.0f};
          PER_POL(p) {
            const float v = pw[p * pstride + t * P.nchan];
            bp[p] = __fadd_rn(__fmul_rn(P.scale, v), __fmul_rn(P.oms, bp[p]));
            op[p] = __fsub_rn(__fdiv_rn(v, bp[p]), 1.0f);
          }
          const float v = P.npol == 2
                              ? __fmul_rn(P.sqrt_half, __fadd_rn(op[0], op[1]))
                              : op[0];
          acc = __fadd_rn(acc, v);
        }
        emit(P, __fmul_rn(acc, P.inv_sqrt_ns), seg * nout + o, c, lane, out);
      }
    } else {
      PER_POL(p) {
        float sum = 0.0f;
        int ngood = 0;
#pragma unroll 8
        for (int t = 0; t < P.ffts; ++t) {
          const float w = weights[(long long)p * P.nblk + t0 + t];
          const float v = pw[p * pstride + (long long)(t0 + t) * P.nchan];
          if (w > 0.0f) {
            sum = __fadd_rn(sum, __fdiv_rn(v, w));
            ++ngood;
          }
        }
        const float seed =
            ngood > 0 ? __fdiv_rn(sum, (float)ngood) : 1.0f;
        float b0 = bp[p] == 0.0f ? seed : bp[p];
        const bool stale = ngood > 0 && (seed > __fmul_rn(5.0f, b0) ||
                                         seed < __fmul_rn(0.2f, b0));
        bp[p] = stale ? seed : b0;
      }
      for (int o = 0; o < nout; ++o) {
        float acc = 0.0f, wsum = 0.0f;
        int cnt = 0;
        for (int q = 0; q < P.nscrunch; ++q) {
          const long long t = t0 + o * P.nscrunch + q;
          float op[2] = {0.0f, 0.0f}, wp[2] = {0.0f, 0.0f};
          PER_POL(p) {
            const float w = weights[(long long)p * P.nblk + t];
            const bool good = w > 0.0f;
            const float x =
                good ? __fdiv_rn(pw[p * pstride + t * P.nchan], w) : 0.0f;
            const bool clipped = x > __fmul_rn(bp[p], P.clip_ratio);
            if (good && !clipped)
              bp[p] = __fadd_rn(__fmul_rn(P.scale, x),
                                __fmul_rn(P.oms, bp[p]));
            op[p] = good ? (clipped ? P.clip_value
                                    : __fsub_rn(__fdiv_rn(x, bp[p]), 1.0f))
                         : 0.0f;
            wp[p] = w;
          }
          float v, wt;
          if (P.npol == 2) {
            const bool g0 = wp[0] >= P.min_weight, g1 = wp[1] >= P.min_weight;
            if (g0 && g1) {
              v = __fmul_rn(P.sqrt_half, __fadd_rn(op[0], op[1]));
              wt = __fmul_rn(0.5f, __fadd_rn(wp[0], wp[1]));
            } else {
              v = __fadd_rn(__fmul_rn(op[0], g0 ? 1.0f : 0.0f),
                            __fmul_rn(op[1], g1 ? 1.0f : 0.0f));
              wt = __fadd_rn(__fmul_rn(wp[0], g0 ? 1.0f : 0.0f),
                             __fmul_rn(wp[1], g1 ? 1.0f : 0.0f));
            }
          } else {
            v = op[0];
            wt = wp[0];
          }
          const bool gt = wt >= P.min_weight;
          const float wg = gt ? wt : 0.0f;
          cnt += gt;
          wsum = __fadd_rn(wsum, wg);
          acc = __fadd_rn(acc, __fmul_rn(wg, v));
        }
        const bool ok = __fmul_rn(wsum, P.rns) >= P.min_weight;
        const float val =
            ok ? __fdiv_rn(acc, sqrtf((float)max(cnt, 1))) : 0.0f;
        emit(P, val, seg * nout + o, c, lane, out);
      }
    }
  }
  if (valid)
    PER_POL(p)
      bp_out[((long long)s * P.npol + p) * P.nchan + c] = bp[p];
}

// The front (rfi_mode > 0), reading the input through `ld`.
template <class Load>
cudaError_t launch_front(const ChainParams& P, const Load& ld, void* keep,
                         void* weights, void* dagcnt, cudaStream_t st) {
  if (P.rfi_mode == 0) return cudaSuccess;
  const size_t sm = (size_t)front_smem_floats(P) * sizeof(float);
  front_kernel<<<P.nblk, 256, sm, st>>>(P, ld, (uint8_t*)keep,
                                        (float*)weights, (int*)dagcnt);
  return cudaGetLastError();
}

cudaError_t launch_ema(const ChainParams& P, const void* power,
                       const void* weights, const void* bp_in, void* bp_out,
                       void* packed, void* packed_kur, const void* dagcnt,
                       void* dag_frac, cudaStream_t st) {
  const int nthr = P.nchan + P.pad;
  ema_kernel<<<dim3((nthr + 63) / 64, num_streams(P)), 64, 0, st>>>(
      P, first_stream(P), (const float*)power, (const float*)weights,
      (const float*)bp_in, (float*)bp_out, (uint8_t*)packed,
      (uint8_t*)packed_kur, (const int*)dagcnt, (float*)dag_frac);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
