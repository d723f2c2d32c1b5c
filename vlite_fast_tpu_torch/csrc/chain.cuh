// The front and the back end of the fused chain, shared by chain.cu
// (every input layout, on the tensor-core DFT of dft_tc.cuh), by
// stage_ab.cu's back end and by ema.cu.  Between them the DFT writes the
// power planes.
//
//   front_kernel  one block per FFT block (both pols): the statistics and
//                 gates of front.cuh, the keep flag per window, the weight
//                 per (pol, block), the flagged-window count per segment;
//                 optionally the blocks flagged in part (some windows
//                 zeroed, not all), as flags and as a list.
//   The EMA in two phases, so that the bandpass recurrence over the
//   second's spectra is the only sequential part and runs alone:
//   bandpass_kernel  one thread per (stream, pol, channel), ~25k threads
//                 at production, fed by a ring of three 32-spectrum chunks
//                 in shared memory (cp.async): per segment the seed (from
//                 the chunk; seed_kernel's, one thread per (stream, pol,
//                 segment, channel), where a segment is longer than a
//                 chunk), the reseed and, on the weighted stream, the
//                 stale test; then the recurrence alone (two dependent
//                 multiply-adds and a compare per spectrum).  It writes
//                 the bandpass each segment starts from.
//   ema_kernel    one thread per (stream, segment, pol, channel), ~8M
//                 threads: from the segment's starting bandpass the same
//                 recurrence again, and per spectrum the normalized power
//                 (weighted: clipped), pscrunch (the other pol by a
//                 shuffle), tscrunch, 2-bit thresholds, and the pack of 4
//                 channels per byte by warp shuffles, written straight as
//                 sel_and_dig rows.
//   The arithmetic and its order are those of one thread walking a
//   channel through the second; both kernels step the bandpass with one
//   function (ema_step), so ema_kernel sees the bandpass bit for bit.
//   That one-thread walk did all of it at ~6 warps per SM and was bound by
//   the latency of its per-spectrum work, not by its loads; split, the
//   walk keeps only the recurrence on its chain and ema_kernel does the
//   rest at full occupancy.  vlite_fast_tpu_torch/ema_probe.py times the
//   launch and variants of it on the card.
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

// The samples of an FFT block staged in shared memory in frame order:
// sample n of pol p at s[p * nfft + n]
template <class T>
struct StagedFrames {
  const T* s;
  int nfft;
  __device__ __forceinline__ float operator()(int p, long long,
                                              int n) const {
    return volt(s[p * nfft + n]);
  }
};

// What the front's statistics read: the raw second in device memory
// (neighbouring lanes, neighbouring bytes), as it is; or block j's CT
// tiles, whose neighbouring samples are 128 lanes apart, staged first into
// `buf` in frame order (16-byte loads of each row's lanes m1 < n1).  The
// statistics read the same values in the same order either way.
__device__ __forceinline__ const NaturalU8& front_input(const ChainParams&,
                                                       const NaturalU8& ld,
                                                       long long, void*) {
  return ld;
}
template <class T>
__device__ __forceinline__ StagedFrames<T> front_input(const ChainParams& P,
                                                       const CtMajor<T>& ld,
                                                       long long j,
                                                       void* buf) {
  constexpr int kV = 16 / sizeof(T);        // elements per 16-byte load
  const int per_row = (P.n1 + kV - 1) / kV;
  T* s = (T*)buf;
  for (int p = 0; p < P.npol; ++p) {
    const T* tile = ld.x + ld.tile(p, j);
    T* dst = s + p * P.nfft;
    for (int v = threadIdx.x; v < P.n2 * per_row; v += blockDim.x) {
      const int m2 = v / per_row, m1 = (v - m2 * per_row) * kV;
      const uint4 d = __ldg((const uint4*)(tile + m2 * 128 + m1));
      const T* e = (const T*)&d;
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (m1 + i < P.n1) dst[(m1 + i) * P.n2 + m2] = e[i];
    }
  }
  __syncthreads();
  return StagedFrames<T>{s, P.nfft};
}

// bytes of shared memory front_input stages for a block
inline int front_staged_bytes(const ChainParams&, const NaturalU8&) {
  return 0;
}
template <class T>
inline int front_staged_bytes(const ChainParams& P, const CtMajor<T>&) {
  return P.npol * P.nfft * (int)sizeof(T);
}

// partial / list / nlist (nullable): partial[j] = 1 where block j kept
// some windows but not all, and those blocks appended to list (in no
// particular order), nlist counting them (zeroed by the caller)
template <class Load>
__global__ void front_kernel(ChainParams P, Load ld,
                             uint8_t* __restrict__ keep,
                             float* __restrict__ weights,
                             int* __restrict__ dagcnt,
                             uint8_t* __restrict__ partial,
                             int* __restrict__ list, int* __restrict__ nlist) {
  extern __shared__ float sm[];
  const int j = blockIdx.x;
  const FrontCounts c =
      front_block(P, front_input(P, ld, j, sm + front_smem_floats(P)), j,
                  sm, keep + (long long)j * P.wpf);
  if (threadIdx.x != 0) return;
  const float wt = __fmul_rn((float)c.nkeep, P.rwpf);
  for (int p = 0; p < P.npol; ++p) weights[(long long)p * P.nblk + j] = wt;
  atomicAdd(&dagcnt[j / P.ffts], c.nflag);
  if (partial) {
    const bool part = c.nkeep > 0 && c.nkeep < P.wpf;
    partial[j] = (uint8_t)part;
    if (part) list[atomicAdd(nlist, 1)] = j;
  }
}

// the 2-bit level of v into the byte of four neighbouring channels
// (lanes 4k .. 4k + 3), written by lane 4k when `store`
__device__ __forceinline__ void emit(const ChainParams& P, float v,
                                     int row, int c, int lane, bool store,
                                     uint8_t* __restrict__ out) {
  const bool in = c >= P.chanmin && c <= P.chanmax;
  const unsigned lev = (v >= P.q0) + (v >= P.q1) + (v >= P.q2);
  unsigned b = in ? lev << (2 * (lane & 3)) : 0u;
  b |= __shfl_xor_sync(0xffffffffu, b, 1);
  b |= __shfl_xor_sync(0xffffffffu, b, 2);
  if (store && in && (lane & 3) == 0)
    out[(long long)row * P.nbytes + (c - P.chanmin) / 4] = (uint8_t)b;
}

// The power planes, f32 (npol, nblk, nchan) each: stream 0 reads `plain`;
// stream 1 reads `kur`, or, with `partial`, kur in the blocks flagged in
// part and plain elsewhere (a block whose windows were all kept has the
// plain power, one with none kept is never read).
__device__ __forceinline__ const float* stream_plane(
    int s, const float* plain, const float* kur, const uint8_t* partial,
    long long t) {
  return (s == 0 || (partial && !__ldg(partial + t))) ? plain : kur;
}

// Stream s's value of a spectrum of power v and this pol's weight w: the
// power, on the weighted stream over the weight (0 where w == 0; v / 1 is
// v, and most blocks keep every window)
template <int s>
__device__ __forceinline__ float ema_x(float v, float w) {
  return s == 0 ? v : (w > 0.0f ? (w == 1.0f ? v : __fdiv_rn(v, w)) : 0.0f);
}

constexpr int kSeedThreads = 128;

// The per-segment seeds of the EMA, one thread per (stream, pol, segment,
// channel): the sum of the segment's spectra in order, times 1/ffts (0 ->
// 1) on the plain stream; on the weighted stream the sum of power /
// weight over the spectra of weight > 0, divided by their count (none ->
// 1).  They depend on no bandpass, so they leave the sequential walk.
// seeds: f32 (2 streams, npol, nseg, nchan), then i32 (npol, nseg): the
// weighted stream's count of spectra of weight > 0 per segment.  Only
// for segments longer than bandpass_kernel's chunk, which otherwise
// computes them itself.
__global__ void __launch_bounds__(kSeedThreads)
    seed_kernel(ChainParams P, int stream0, const float* __restrict__ plain,
                const float* __restrict__ kur,
                const uint8_t* __restrict__ partial,
                const float* __restrict__ weights,
                float* __restrict__ seeds) {
  const int s = stream0 + blockIdx.z / P.npol, p = blockIdx.z % P.npol;
  const int seg = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.nchan) return;
  const long long t0 = (long long)seg * P.ffts;
  const long long pstride = (long long)P.nblk * P.nchan;
  float sum = 0.0f;
  int ngood = 0;
#pragma unroll 8
  for (int t = 0; t < P.ffts; ++t) {
    const float v = __ldg(stream_plane(s, plain, kur, partial, t0 + t) +
                          p * pstride + (t0 + t) * P.nchan + c);
    if (s == 0) {
      sum = __fadd_rn(sum, v);
    } else {
      const float w = __ldg(weights + p * P.nblk + t0 + t);
      if (w > 0.0f) {
        sum = __fadd_rn(sum, ema_x<1>(v, w));
        ++ngood;
      }
    }
  }
  float seed;
  if (s == 0) {
    seed = __fmul_rn(sum, P.rffts);
    if (seed == 0.0f) seed = 1.0f;
  } else {
    seed = ngood > 0 ? __fdiv_rn(sum, (float)ngood) : 1.0f;
  }
  seeds[(((long long)s * P.npol + p) * P.nseg + seg) * P.nchan + c] = seed;
  if (s == 1 && c == 0)
    ((int*)(seeds + 2LL * P.npol * P.nseg * P.nchan))[p * P.nseg + seg] =
        ngood;
}

// One step of stream s's bandpass recurrence on x = ema_x(v, w), good =
// the spectrum counts (w > 0): returns whether x was clipped (above the
// clip ratio times the bandpass; weighted stream); bp advances where the
// spectrum counts and was not clipped.  bandpass_kernel and ema_kernel
// both walk it, so both see the same bandpass bit for bit.
template <int s>
__device__ __forceinline__ bool ema_step(const ChainParams& P, float x,
                                         bool good, float& bp) {
  const bool clipped = s == 1 && x > __fmul_rn(bp, P.clip_ratio);
  // a select, not a branch: `clipped` differs between channels
  const float next = __fadd_rn(__fmul_rn(P.scale, x), __fmul_rn(P.oms, bp));
  bp = good && !clipped ? next : bp;
  return clipped;
}

// the bandpass at a segment's start: the seed where it is 0, and on the
// weighted stream the seed where the bandpass went stale (the seed five
// times above it or five times below, given spectra of weight > 0)
template <int s>
__device__ __forceinline__ float reseed(float bp, float seed, int ngood) {
  if (s == 0) return bp == 0.0f ? seed : bp;
  const float b0 = bp == 0.0f ? seed : bp;
  const bool stale = ngood > 0 && (seed > __fmul_rn(5.0f, b0) ||
                                   seed < __fmul_rn(0.2f, b0));
  return stale ? seed : b0;
}

constexpr int kBpThreads = 64;    // channels of one (stream, pol) per block
constexpr int kBpChunk = 32;      // spectra per chunk of the walk
constexpr int kBpStages = 3;      // chunks in the ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes from device memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the bandpass walk's ring: the chunks' power (each thread its channel's
// column) and weights (each warp its copy)
struct BpRing {
  float v[kBpStages][kBpChunk][kBpThreads];
  float w[kBpStages][kBpThreads / 32][kBpChunk];
};

// Phase 1 of the EMA: the bandpass recurrence alone, one thread per
// (stream, pol, channel).  Per segment it writes the bandpass the segment
// starts from (after reseeding) over that segment's seed, for ema_kernel,
// and at the end the second's bandpass.  Where a segment fits one chunk
// (ffts <= kBpChunk, the production geometry's 32) the seed comes from
// the chunk and seed_kernel does not run.
//
// The loads go through a ring of kBpStages chunks in shared memory, each
// thread copying its own channel's 32 spectra with cp.async (4 bytes: a
// plane's rows, nchan floats, start only 4-byte aligned), the warp's
// lanes the chunk's 32 weights; two chunks are in flight while one is
// walked (~48 KB per SM, ~6 MB over the launch, what the memory's latency
// needs).  The seed pass and the walk read the chunk from shared memory,
// so their loops need not be unrolled over register arrays (the weighted
// stream's unrolled body, with a divide and branches per spectrum, was
// several times the plain stream's).  The divides by a weight other than
// 0 and 1 run first, in place, over a mask of the chunk's spectra, so
// neither the seed's sum nor the recurrence waits on a divide.
template <int s>
__device__ __forceinline__ void bandpass_walk(
    const ChainParams& P, const float* __restrict__ plain,
    const float* __restrict__ kur, const uint8_t* __restrict__ partial,
    const float* __restrict__ weights, float* __restrict__ seeds,
    const float* __restrict__ bp_in, float* __restrict__ bp_out,
    BpRing& ring) {
  auto& vring = ring.v;
  auto& wring = ring.w;
  const int p = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.x * kBpThreads + tid;
  const bool valid = c < P.nchan;          // the others walk channel nchan-1
  const int cl = min(c, P.nchan - 1);      // and write nothing
  const long long pstride = (long long)P.nblk * P.nchan;
  const float* plain_c = plain + p * pstride + cl;
  const float* kur_c = kur + p * pstride + cl;
  const float* w_p = weights + p * P.nblk;
  float* start_of =
      seeds + ((long long)s * P.npol + p) * P.nseg * P.nchan + cl;
  const int* ngood_of =
      (const int*)(seeds + 2LL * P.npol * P.nseg * P.nchan) + p * P.nseg;
  const bool fused = P.ffts <= kBpChunk;   // seeds from the chunk
  const int nch = (P.ffts + kBpChunk - 1) / kBpChunk;
  const int nchunks = P.nseg * nch;
  const bool pick = s == 1 && partial;
  // chunk q: spectra [first(q), first(q) + count(q)) of segment q / nch
  auto first = [&](int q) {
    return (long long)(q / nch) * P.ffts + (q % nch) * kBpChunk;
  };
  auto count = [&](int q) {
    return min(kBpChunk, P.ffts - (q % nch) * kBpChunk);
  };
  // this lane's partial flag of the next chunk to fetch, loaded one fetch
  // ahead, so that no copy's address waits on a flag
  uint32_t flag = 0;
  auto load_flag = [&](int q) {
    if (pick && q < nchunks && lane < count(q))
      flag = __ldg(partial + first(q) + lane);
  };
  // chunk q into stage q % kBpStages (one commit group, empty past the end)
  auto fetch = [&](int q) {
    if (q < nchunks) {
      const long long t0 = first(q);
      const int n = count(q), st = q % kBpStages;
      const uint32_t kur_of = s == 0 ? 0u
                              : pick ? __ballot_sync(0xffffffffu, flag != 0)
                                     : 0xffffffffu;
      for (int u = 0; u < n; ++u)
        cp_async4(&vring[st][u][tid],
                  ((kur_of >> u) & 1 ? kur_c : plain_c) + (t0 + u) * P.nchan);
      if (s == 1 && lane < n)
        cp_async4(&wring[st][warp][lane], w_p + t0 + lane);
      load_flag(q + 1);
    }
    cp_async_commit();
  };
  float bp = bp_in[((long long)s * P.npol + p) * P.nchan + cl];
  load_flag(0);
  for (int q = 0; q < kBpStages - 1; ++q) fetch(q);
  for (int q = 0; q < nchunks; ++q) {
    // the stage of chunk q - 1 was read in full (by every lane: the
    // weights) before this copy
    __syncwarp();
    fetch(q + kBpStages - 1);
    cp_async_wait<kBpStages - 1>();
    __syncwarp();   // the other lanes' weights of chunk q have landed
    const int seg = q / nch, n = count(q), st = q % kBpStages;
    // x = ema_x(v, w) in place: the divides by a weight other than 0 and 1
    // first, over a mask of the chunk's spectra (independent of each
    // other and of the bandpass); then the seed and the walk, whose
    // chains hold no divide and no branch
    float* xs = &vring[st][0][tid];
    const float* ws = wring[st][warp];
    uint32_t good;
    if (s == 1) {
      const float wl = lane < n ? ws[lane] : 0.0f;
      good = __ballot_sync(0xffffffffu, wl > 0.0f);
      for (uint32_t m = __ballot_sync(0xffffffffu, wl > 0.0f && wl != 1.0f);
           m; m &= m - 1) {
        const int u = __ffs(m) - 1;
        xs[u * kBpThreads] = __fdiv_rn(xs[u * kBpThreads], ws[u]);
      }
    } else {
      good = __ballot_sync(0xffffffffu, lane < n);
    }
    if (q % nch == 0) {
      float seed;
      int ngood = 0;
      if (fused) {
        // seed_kernel's sums, in its order
        float sum = 0.0f;
#pragma unroll 8
        for (int u = 0; u < n; ++u) {
          const bool g = (good >> u) & 1;
          sum = g ? __fadd_rn(sum, xs[u * kBpThreads]) : sum;
          ngood += g;
        }
        if (s == 0) {
          seed = __fmul_rn(sum, P.rffts);
          if (seed == 0.0f) seed = 1.0f;
        } else {
          seed = ngood > 0 ? __fdiv_rn(sum, (float)ngood) : 1.0f;
        }
      } else {
        seed = start_of[(long long)seg * P.nchan];
        if (s == 1) ngood = ngood_of[seg];
      }
      bp = reseed<s>(bp, seed, ngood);
      if (valid) start_of[(long long)seg * P.nchan] = bp;
    }
#pragma unroll 8
    for (int u = 0; u < n; ++u)
      ema_step<s>(P, xs[u * kBpThreads], (good >> u) & 1, bp);
  }
  cp_async_wait<0>();
  if (valid) bp_out[((long long)s * P.npol + p) * P.nchan + c] = bp;
}

__global__ void __launch_bounds__(kBpThreads)
    bandpass_kernel(ChainParams P, int stream0, const float* __restrict__ plain,
                    const float* __restrict__ kur,
                    const uint8_t* __restrict__ partial,
                    const float* __restrict__ weights,
                    float* __restrict__ seeds,
                    const float* __restrict__ bp_in,
                    float* __restrict__ bp_out) {
  __shared__ BpRing ring;
  if (stream0 + blockIdx.z == 0)
    bandpass_walk<0>(P, plain, kur, partial, weights, seeds, bp_in, bp_out,
                     ring);
  else
    bandpass_walk<1>(P, plain, kur, partial, weights, seeds, bp_in, bp_out,
                     ring);
}

constexpr int kEmaThreads = 256;  // 128 channels x 2 pols per block
constexpr int kEmaChunk = 8;      // spectra per chunk of a segment

// Phase 2 of the EMA: one thread per (stream, segment, pol, channel), all
// segments at once: from the bandpass the segment starts from
// (bandpass_kernel), the recurrence again (the same steps, so the same
// values), and per spectrum the normalized power (weighted: clipped),
// pscrunch, tscrunch and the 2-bit pack.  Lanes 0-15 of a warp hold pol 0
// and lanes 16-31 pol 1 of the same 16 channels (npol 1: the upper lanes
// shadow pol 0 and write nothing), and a shuffle brings the other pol's
// value for the scrunch.  ~8M threads at production: the launch has the
// parallelism the walk lacks, and its loads and divides are independent
// across spectra.
template <int s>   // 0 plain, 1 weighted
__device__ __forceinline__ void ema_segment(
    const ChainParams& P, const float* __restrict__ plain,
    const float* __restrict__ kur, const uint8_t* __restrict__ partial,
    const float* __restrict__ weights, const float* __restrict__ seeds,
    uint8_t* __restrict__ packed, uint8_t* __restrict__ packed_kur,
    const int* __restrict__ dagcnt, float* __restrict__ dag_frac) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pl = lane >> 4;              // this lane's pol
  const int p = min(pl, P.npol - 1);     // the pol it walks
  // channel with (c - chanmin) % 4 == lane % 4, so four neighbouring
  // lanes hold the four channels of one output byte
  const int c = (blockIdx.x * (kEmaThreads / 32) + warp) * 16 + (lane & 15) -
                P.pad;
  const int cl = min(max(c, 0), P.nchan - 1);
  const int seg = blockIdx.y;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int k = threadIdx.x; k < P.nseg; k += blockDim.x)
      dag_frac[k] = __fmul_rn((float)dagcnt[k], P.rwin);
  const long long pstride = (long long)P.nblk * P.nchan;   // per pol
  float bp = seeds[(((long long)s * P.npol + p) * P.nseg + seg) * P.nchan +
                   cl];
  uint8_t* out = s == 0 ? packed : packed_kur;
  const float* plain_c = plain + p * pstride + cl;
  const float* kur_c = kur + p * pstride + cl;
  const int nout = P.ffts / P.nscrunch;
  const long long t0 = (long long)seg * P.ffts;
  float acc = 0.0f, wsum = 0.0f;
  int cnt = 0, q = 0, o = 0;
  for (int u0 = 0; u0 < P.ffts; u0 += kEmaChunk) {
    float v[kEmaChunk], w0[kEmaChunk], w1[kEmaChunk];
#pragma unroll
    for (int u = 0; u < kEmaChunk; ++u) {
      v[u] = w0[u] = w1[u] = 0.0f;
      if (u0 + u < P.ffts) {
        const long long t = t0 + u0 + u;
        v[u] = __ldg((s == 0 || (partial && !__ldg(partial + t)) ? plain_c
                                                                  : kur_c) +
                     t * P.nchan);
        if (s == 1) {
          w0[u] = __ldg(weights + t);
          w1[u] = P.npol == 2 ? __ldg(weights + P.nblk + t) : 0.0f;
        }
      }
    }
    float op[kEmaChunk];
#pragma unroll
    for (int u = 0; u < kEmaChunk; ++u) {
      op[u] = 0.0f;
      if (u0 + u < P.ffts) {
        const float wo = p == 0 ? w0[u] : w1[u];   // this pol's
        const bool good = s == 0 || wo > 0.0f;
        const float x = ema_x<s>(v[u], wo);
        const bool clipped = ema_step<s>(P, x, good, bp);
        op[u] = good ? (clipped ? P.clip_value
                                : __fsub_rn(__fdiv_rn(x, bp), 1.0f))
                     : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kEmaChunk; ++u) {
      if (u0 + u >= P.ffts) break;
      const float other = __shfl_xor_sync(0xffffffffu, op[u], 16);
      const float op0 = pl == 0 ? op[u] : other;
      const float op1 = pl == 0 ? other : op[u];
      if (s == 0) {
        const float val =
            P.npol == 2 ? __fmul_rn(P.sqrt_half, __fadd_rn(op0, op1)) : op0;
        acc = __fadd_rn(acc, val);
        if (++q == P.nscrunch) {
          emit(P, __fmul_rn(acc, P.inv_sqrt_ns), seg * nout + o, c, lane,
               pl == 0, out);
          ++o;
          acc = 0.0f;
          q = 0;
        }
      } else {
        float val, wt;
        if (P.npol == 2) {
          const bool g0 = w0[u] >= P.min_weight, g1 = w1[u] >= P.min_weight;
          if (g0 && g1) {
            val = __fmul_rn(P.sqrt_half, __fadd_rn(op0, op1));
            wt = __fmul_rn(0.5f, __fadd_rn(w0[u], w1[u]));
          } else {
            val = __fadd_rn(__fmul_rn(op0, g0 ? 1.0f : 0.0f),
                            __fmul_rn(op1, g1 ? 1.0f : 0.0f));
            wt = __fadd_rn(__fmul_rn(w0[u], g0 ? 1.0f : 0.0f),
                           __fmul_rn(w1[u], g1 ? 1.0f : 0.0f));
          }
        } else {
          val = op0;
          wt = w0[u];
        }
        const bool gt = wt >= P.min_weight;
        const float wg = gt ? wt : 0.0f;
        cnt += gt;
        wsum = __fadd_rn(wsum, wg);
        acc = __fadd_rn(acc, __fmul_rn(wg, val));
        if (++q == P.nscrunch) {
          const bool ok = __fmul_rn(wsum, P.rns) >= P.min_weight;
          const float res =
              ok ? __fdiv_rn(acc, sqrtf((float)max(cnt, 1))) : 0.0f;
          emit(P, res, seg * nout + o, c, lane, pl == 0, out);
          ++o;
          acc = wsum = 0.0f;
          cnt = q = 0;
        }
      }
    }
  }
}

// the stream is a template parameter, so neither instance branches on it
// inside its unrolled chunks
__global__ void __launch_bounds__(kEmaThreads)
    ema_kernel(ChainParams P, int stream0, const float* __restrict__ plain,
               const float* __restrict__ kur,
               const uint8_t* __restrict__ partial,
               const float* __restrict__ weights,
               const float* __restrict__ seeds,
               uint8_t* __restrict__ packed, uint8_t* __restrict__ packed_kur,
               const int* __restrict__ dagcnt, float* __restrict__ dag_frac) {
  if (stream0 + blockIdx.z == 0)
    ema_segment<0>(P, plain, kur, partial, weights, seeds, packed,
                   packed_kur, dagcnt, dag_frac);
  else
    ema_segment<1>(P, plain, kur, partial, weights, seeds, packed,
                   packed_kur, dagcnt, dag_frac);
}

// The front (rfi_mode > 0), reading the input through `ld`; partial /
// list / nlist as front_kernel's.
template <class Load>
cudaError_t launch_front(const ChainParams& P, const Load& ld, void* keep,
                         void* weights, void* dagcnt, cudaStream_t st,
                         void* partial = nullptr, void* list = nullptr,
                         void* nlist = nullptr) {
  if (P.rfi_mode == 0) return cudaSuccess;
  const int sm = front_smem_floats(P) * (int)sizeof(float) +
                 front_staged_bytes(P, ld);
  if (sm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        front_kernel<Load>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (e != cudaSuccess) return e;
  }
  front_kernel<<<P.nblk, 256, sm, st>>>(
      P, ld, (uint8_t*)keep, (float*)weights, (int*)dagcnt,
      (uint8_t*)partial, (int*)list, (int*)nlist);
  return cudaGetLastError();
}

// plain / kur / partial as stream_plane's; seeds scratch of 2 npol nseg
// nchan + npol nseg floats (seed_kernel's seeds and counts, then the
// bandpass each segment starts from)
cudaError_t launch_ema(const ChainParams& P, const void* plain,
                       const void* kur, const void* partial,
                       const void* weights, void* seeds, const void* bp_in,
                       void* bp_out, void* packed, void* packed_kur,
                       const void* dagcnt, void* dag_frac, cudaStream_t st) {
  const int ns = num_streams(P), s0 = first_stream(P);
  cudaError_t e;
  if (P.ffts > kBpChunk) {
    seed_kernel<<<dim3((P.nchan + kSeedThreads - 1) / kSeedThreads, P.nseg,
                       ns * P.npol),
                  kSeedThreads, 0, st>>>(
        P, s0, (const float*)plain, (const float*)kur,
        (const uint8_t*)partial, (const float*)weights, (float*)seeds);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  bandpass_kernel<<<dim3((P.nchan + kBpThreads - 1) / kBpThreads, P.npol, ns),
                    kBpThreads, 0, st>>>(
      P, s0, (const float*)plain, (const float*)kur, (const uint8_t*)partial,
      (const float*)weights, (float*)seeds, (const float*)bp_in,
      (float*)bp_out);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int per_block = kEmaThreads / 2;   // channels
  ema_kernel<<<dim3((P.nchan + P.pad + per_block - 1) / per_block, P.nseg,
                    ns),
               kEmaThreads, 0, st>>>(
      P, s0, (const float*)plain, (const float*)kur, (const uint8_t*)partial,
      (const float*)weights, (const float*)seeds, (uint8_t*)packed,
      (uint8_t*)packed_kur, (const int*)dagcnt, (float*)dag_frac);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
