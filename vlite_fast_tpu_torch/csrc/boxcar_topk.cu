// The gulp's boxcar S/N and its banded top-k without the S/N cube, hand-
// written for Hopper (sm_90a).  Called through ctypes from
// ops/boxcar_topk.py (models/search.boxcar_topk).
//
// Replaces no TPU kernel: the JAX package leaves boxcar_snr and
// pack_topk_banded to XLA.  The port's torch passes wrote the whole
// (nw, ndm, ntime) float32 S/N cube (2.1 GB a production gulp, 3.5 GB an
// array search) and then sorted it; these two launches compute the same
// (2, nbands*kb + 1) int32 crossings and never write the cube.
//
// What bounds it: one read of the DM-time plane (299 MB a production gulp,
// ~0.09 ms at 3.35 TB/s) against ndm*ntime*(2 + 3*nw) f32 operations
// (~1.7 G, ~0.03 ms at 67 TFLOP/s): memory.  Each pass reads each row once
// into shared memory and works there.
//
//   pass 1 (boxcar_stats_kernel, stage "boxcar"), a block a DM row:
//     the row into shared memory (whole where it fits; else chunks of
//     kChunk outputs behind a halo of wmax - 1 samples), its mean, the
//     exact median of |x - mean| over the strided subsample (a radix
//     select on the float bits in shared memory: digits of 11, 11 and 10
//     bits), sigma = max(1.4826 median, 1e-6) or the expected sigma, then
//     every width's box sums and S/N; each crossing (S/N > thresh) counted
//     and added to its DM band's histogram of the top 16 bits of its f32
//     pattern (kStage bins above thresh's in shared memory, flushed once;
//     the rest straight to device memory).  The row's mean and 1/sigma
//     are kept for pass 2.
//   pass 2 (topk_kernel, stage "topk"), one cooperative launch of
//     resident blocks over the rows, phases between grid barriers:
//     each band's cutoff bin c1 from its histogram (a band with no more
//     than kb crossings takes them all); where a band has more, its rows
//     again, the cutoff bin's crossings by their low 16 bits, and the
//     exact kb-th value v*; then every row again, each crossing kept
//     (above v*, or equal to it while the band's share of equal values
//     lasts) written to the band's item list; last each band's items
//     sorted (S/N descending, flat index ascending) and written out, -inf
//     and index 0 in the slots left over.
//
// The S/N is pass 1's and pass 2's to the bit: both run sweep() on the
// same rows, chunks and thread runs with the mean and 1/sigma pass 1
// stored.  A thread's run of outputs starts from direct sums of the
// wmax samples behind it and slides each box by the sample entering and
// the one leaving it: each box is the sum of at most a run's length of
// roundings off the exact, where torch.cumsum's differences carry the
// rounding of the whole row's running sum.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 10;         // widths 1, 2, 4, ..., 512
constexpr int kStage = 2048;      // pass 1's shared bins from thresh's up
constexpr int kBins = 65536;      // a band's histogram of 16-bit keys
constexpr int kChunk = 16384;     // outputs a chunk where a row does not fit
constexpr int kBandWords = 8;
constexpr int kScratch = 64;      // words of block scratch
constexpr unsigned kNegInf = 0xFF800000u;

// a band's words: its crossings, whether it has more than kb, the cutoff
// bin, the crossings above it, v*, the equal values it keeps, the items
// written, the equal values met
enum { kTotal, kSat, kC1, kAbove1, kVstar, kNeedEq, kItems, kTies };

struct Params {
  const float* dmt;  // (ndm, nt) f32
  int ndm, nt;       // rows; outputs a row
  int skip, ntf;     // outputs before the row's first (S/N 0); the frame
  int nw, P;         // widths 1 .. 2^(nw-1); shared offset of output 0
  int ch, whole;     // outputs a chunk; 1 where the row is one chunk
  int step, nsub;    // the median's subsample: its step and length
  int nbands, dmb, kb, cap;  // cap: items a band (a power of 2 >= kb)
  float sigma;       // > 0: the expected sigma; 0: measured
  float thresh;
  unsigned lo;       // thresh's 16-bit key
  float scale[kMaxW];
  uint32_t* hist1;   // nbands x kBins
  uint32_t* hist2;   // nbands x kBins
  uint32_t* band;    // nbands x kBandWords
  uint32_t* bar;     // the grid barrier: arrivals, generation
  float2* rowstat;   // ndm x (mean, 1/sigma)
  unsigned long long* items;  // nbands x cap
  int32_t* out;      // (2, nbands*kb + 1)
};

// Workspace (bytes from 0): hist1, hist2, band, bar (zeroed each call),
// then rowstat and items.
struct Layout {
  size_t hist1, hist2, band, bar, zero_bytes, rowstat, items, bytes;
};

Layout layout(int ndm, int nbands, int cap) {
  Layout L;
  L.hist1 = 0;
  L.hist2 = L.hist1 + (size_t)nbands * kBins * 4;
  L.band = L.hist2 + (size_t)nbands * kBins * 4;
  L.bar = L.band + (size_t)nbands * kBandWords * 4;
  L.zero_bytes = L.bar + 16;
  L.rowstat = L.zero_bytes;
  L.items = (L.rowstat + (size_t)ndm * 8 + 15) / 16 * 16;
  L.bytes = L.items + (size_t)nbands * cap * 8;
  return L;
}

__host__ __device__ int pow2_at_least(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

// pass 1's shared memory: its bins and scratch, then the floats
size_t smem1(const Params& p) {
  return (size_t)(kStage + kScratch) * 4 +
         (size_t)(p.P + p.ch + (p.whole ? 0 : p.nsub)) * sizeof(float);
}

size_t smem2(const Params& p) {
  return (size_t)kScratch * 4 + (size_t)(p.P + p.ch) * sizeof(float);
}

// ---------------------------------------------------------------- block
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ unsigned warp_sum_u(unsigned v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_min_u(unsigned v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// every thread gets the block's total; ws: kWarps + 1 words
__device__ float block_sum(float v, float* ws) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) ws[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = l < kWarps ? ws[l] : 0.f;
    t = warp_sum(t);
    if (l == 0) ws[kWarps] = t;
  }
  __syncthreads();
  const float r = ws[kWarps];
  __syncthreads();
  return r;
}

__device__ unsigned block_sum_u(unsigned v, uint32_t* ws) {
  v = warp_sum_u(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) ws[w] = v;
  __syncthreads();
  if (w == 0) {
    unsigned t = l < kWarps ? ws[l] : 0u;
    t = warp_sum_u(t);
    if (l == 0) ws[kWarps] = t;
  }
  __syncthreads();
  const unsigned r = ws[kWarps];
  __syncthreads();
  return r;
}

__device__ unsigned block_min_u(unsigned v, uint32_t* ws) {
  v = warp_min_u(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) ws[w] = v;
  __syncthreads();
  if (w == 0) {
    unsigned t = l < kWarps ? ws[l] : ~0u;
    t = warp_min_u(t);
    if (l == 0) ws[kWarps] = t;
  }
  __syncthreads();
  const unsigned r = ws[kWarps];
  __syncthreads();
  return r;
}

// the sum of v over the threads before this one; ws: kWarps + 1 words
__device__ unsigned block_excl_scan(unsigned v, uint32_t* ws) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(~0u, inc, o);
    if (l >= o) inc += n;
  }
  if (l == 31) ws[w] = inc;
  __syncthreads();
  if (w == 0) {
    unsigned t = l < kWarps ? ws[l] : 0u;
    unsigned ti = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(~0u, ti, o);
      if (l >= o) ti += n;
    }
    if (l < kWarps) ws[l] = ti - t;
  }
  __syncthreads();
  const unsigned r = ws[w] + inc - v;
  __syncthreads();
  return r;
}

// The bin of nb counters (nb a multiple of kThreads) that holds rank r
// (0-based; in bin order, or from the top when desc) and the count
// before it in that order, to out[0], out[1] for every thread.  count(b)
// reads bin b.  r must be below the counters' sum.
template <class Count>
__device__ void find_rank(Count count, int nb, unsigned r, bool desc,
                          uint32_t* ws, uint32_t* out) {
  const int per = nb / kThreads;
  const int base = threadIdx.x * per;
  unsigned local = 0;
  for (int j = 0; j < per; ++j)
    local += count(desc ? nb - 1 - (base + j) : base + j);
  const unsigned excl = block_excl_scan(local, ws);
  if (excl <= r && r < excl + local) {
    unsigned c = excl;
    for (int j = 0; j < per; ++j) {
      const int b = desc ? nb - 1 - (base + j) : base + j;
      const unsigned h = count(b);
      if (r < c + h) {
        out[0] = b;
        out[1] = c;
        break;
      }
      c += h;
    }
  }
  __syncthreads();
}

// the k-th smallest (0-based) of n non-negative floats' bits, get(i)
template <class Get>
__device__ unsigned select_kth(Get get, int n, unsigned k, uint32_t* h,
                               uint32_t* ws) {
  unsigned prefix = 0, pmask = 0;
  const int shifts[3] = {21, 10, 0}, bits[3] = {11, 11, 10};
  for (int pass = 0; pass < 3; ++pass) {
    const int sh = shifts[pass], nb = 1 << bits[pass];
    for (int i = threadIdx.x; i < nb; i += kThreads) h[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned u = get(i);
      if ((u & pmask) == prefix) atomicAdd(&h[(u >> sh) & (nb - 1)], 1u);
    }
    __syncthreads();
    find_rank([&](int b) { return h[b]; }, nb, k, false, ws, ws + 32);
    const unsigned bin = ws[32];
    k -= ws[33];
    __syncthreads();
    prefix |= bin << sh;
    pmask |= (unsigned)(nb - 1) << sh;
  }
  return prefix;
}

// one add of the warp's lanes that name the same counter
__device__ __forceinline__ void agg_inc(uint32_t* c) {
  const unsigned m =
      __match_any_sync(__activemask(), (unsigned long long)(uintptr_t)c);
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(c, (unsigned)__popc(m));
}

// ---------------------------------------------------------------- S/N
// Every width's S/N at the chunk's L outputs t = c0 + i (i in [0, L)),
// from s[i] = x[c0 + i], i in [-(wmax - 1), L) (zeros before the row):
// fn(k, t, snr) for width 2^k where t >= 2^k - 1.  A thread takes a
// contiguous run (odd length: no bank conflicts between the runs' reads).
template <class Fn>
__device__ __forceinline__ void sweep(const float* s, int L, int c0,
                                      const Params& p, float inv, Fn&& fn) {
  int S = (L + kThreads - 1) / kThreads;
  S |= 1;
  const int a = threadIdx.x * S;
  const int e = min(a + S, L);
  if (a >= e) return;
  float box[kMaxW];
  {
    float acc = 0.f;
    int j = 0;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (k < p.nw) {
        for (; j < (1 << k); ++j) acc = __fadd_rn(acc, s[a - j]);
        box[k] = acc;
      }
    }
  }
  for (int i = a; i < e; ++i) {
    const float xi = s[i];
    const int t = c0 + i;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (k < p.nw) {
        if (i > a) box[k] = __fadd_rn(box[k], __fsub_rn(xi, s[i - (1 << k)]));
        if (t >= (1 << k) - 1)
          fn(k, t, __fmul_rn(__fmul_rn(box[k], inv), p.scale[k]));
      }
    }
  }
}

// buf[p.P + j] = x[c0 + j] for j in [-(wmax - 1), L): the chunk and the
// halo behind it, the row's mean taken off (0 before the row)
__device__ void load_chunk(const Params& p, const float* row, float mean,
                           float* buf, int c0, int L) {
  const int H = (1 << (p.nw - 1)) - 1;
  float* s = buf + p.P;
  for (int j = (int)threadIdx.x - H; j < L; j += kThreads) {
    const int t = c0 + j;
    s[j] = t >= 0 ? __fsub_rn(__ldg(row + t), mean) : 0.f;
  }
}

// the whole row: s[i] = row[i] (mean 0) or row[i] - mean, zeros before
// it; returns this thread's sum of the raw values it loaded
__device__ float load_row(const Params& p, const float* row, float mean,
                          float* buf) {
  for (int j = threadIdx.x; j < p.P; j += kThreads) buf[j] = 0.f;
  float* s = buf + p.P;
  float sum = 0.f;
  const bool vec = ((uintptr_t)row & 15) == 0 && (p.nt & 3) == 0 &&
                   (p.P & 3) == 0;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int i = threadIdx.x; i < p.nt / 4; i += kThreads) {
      float4 v = __ldg(r4 + i);
      sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, v.x), v.y), v.z),
                      v.w);
      v.x = __fsub_rn(v.x, mean);
      v.y = __fsub_rn(v.y, mean);
      v.z = __fsub_rn(v.z, mean);
      v.w = __fsub_rn(v.w, mean);
      s4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < p.nt; i += kThreads) {
      const float v = __ldg(row + i);
      sum = __fadd_rn(sum, v);
      s[i] = __fsub_rn(v, mean);
    }
  }
  return sum;
}

// Every chunk of row d through sweep; whole rows are loaded by the caller.
template <class Fn>
__device__ void row_snr(const Params& p, int d, float mean, float inv,
                        float* buf, Fn&& fn) {
  const float* row = p.dmt + (size_t)d * p.nt;
  for (int c0 = 0; c0 < p.nt; c0 += p.ch) {
    const int L = min(p.ch, p.nt - c0);
    if (!p.whole) {
      load_chunk(p, row, mean, buf, c0, L);
      __syncthreads();
    }
    sweep(buf + p.P, L, c0, p, inv, fn);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- pass 1
__global__ void __launch_bounds__(kThreads, 2)
    boxcar_stats_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);  // kStage bins
  uint32_t* ws = stage + kStage;                        // kScratch words
  float* buf = reinterpret_cast<float*>(ws + kScratch);
  float* sub = buf + p.P + p.ch;  // chunked rows: the median's subsample
  const int d = blockIdx.x;
  const int b = d / p.dmb;
  const float* row = p.dmt + (size_t)d * p.nt;

  // the mean (a whole row staged raw, its mean taken off in place)
  float part = 0.f;
  if (p.whole) {
    part = load_row(p, row, 0.f, buf);
  } else {
    for (int i = threadIdx.x; i < p.nt; i += kThreads)
      part = __fadd_rn(part, __ldg(row + i));
  }
  const float mean =
      __fmul_rn(block_sum(part, reinterpret_cast<float*>(ws)),
                1.0f / (float)p.nt);
  float* s = buf + p.P;
  if (p.whole) {
    for (int i = threadIdx.x; i < p.nt; i += kThreads)
      s[i] = __fsub_rn(s[i], mean);
  } else {
    for (int i = threadIdx.x; i < p.nsub; i += kThreads)
      sub[i] = fabsf(__fsub_rn(__ldg(row + (size_t)i * p.step), mean));
  }
  __syncthreads();

  // sigma
  float sigma = p.sigma;
  if (sigma <= 0.f) {
    auto get = [&](int i) {
      return __float_as_uint(p.whole ? fabsf(s[i * p.step]) : sub[i]);
    };
    const unsigned k1 = (p.nsub - 1) / 2, k2 = p.nsub / 2;
    const unsigned v1 = select_kth(get, p.nsub, k1, stage, ws);
    unsigned v2 = v1;
    if (k2 != k1) {
      unsigned le = 0, mn = ~0u;
      for (int i = threadIdx.x; i < p.nsub; i += kThreads) {
        const unsigned u = get(i);
        le += u <= v1;
        if (u > v1) mn = min(mn, u);
      }
      le = block_sum_u(le, ws);
      mn = block_min_u(mn, ws);
      if (le <= k2) v2 = mn;
    }
    const float med = __fmul_rn(
        __fadd_rn(__uint_as_float(v1), __uint_as_float(v2)), 0.5f);
    sigma = __fmul_rn(1.4826f, med);
    sigma = sigma < 1e-6f ? 1e-6f : sigma;
  }
  const float inv = __frcp_rn(sigma);
  if (threadIdx.x == 0) p.rowstat[d] = make_float2(mean, inv);
  for (int i = threadIdx.x; i < kStage; i += kThreads) stage[i] = 0;
  __syncthreads();

  // the crossings: counted, and binned by their top 16 bits
  uint32_t* h1 = p.hist1 + (size_t)b * kBins;
  unsigned cnt = 0;
  row_snr(p, d, mean, inv, buf, [&](int, int, float v) {
    if (v > p.thresh) {
      ++cnt;
      const unsigned key = __float_as_uint(v) >> 16;
      const unsigned r = key - p.lo;
      agg_inc(r < (unsigned)kStage ? stage + r : h1 + key);
    }
  });
  cnt = block_sum_u(cnt, ws);
  if (threadIdx.x == 0 && cnt) atomicAdd(p.band + b * kBandWords + kTotal, cnt);
  for (int i = threadIdx.x; i < kStage; i += kThreads) {
    const unsigned c = stage[i];
    if (c) atomicAdd(h1 + p.lo + i, c);
  }
}

// ---------------------------------------------------------------- pass 2
// All the launch's blocks are resident (a cooperative launch): each
// arrives, and waits for the last one of this generation.
__device__ void grid_sync(uint32_t* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile uint32_t* vb = bar;
    const unsigned gen = vb[1];
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      vb[0] = 0;
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (vb[1] == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned ld_band(const Params& p, int b, int w) {
  return __ldcg(p.band + b * kBandWords + w);
}

// the whole row d into buf (its mean taken off), or nothing for chunks
__device__ void stage_row(const Params& p, int d, float mean, float* buf) {
  if (p.whole) {
    load_row(p, p.dmt + (size_t)d * p.nt, mean, buf);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2) topk_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);  // kScratch words
  float* buf = reinterpret_cast<float*>(ws + kScratch);

  // each band's cutoff bin, where it has more than kb crossings
  for (int b = blockIdx.x; b < p.nbands; b += gridDim.x) {
    if (ld_band(p, b, kTotal) > (unsigned)p.kb) {
      const uint32_t* h = p.hist1 + (size_t)b * kBins;
      find_rank([&](int i) { return __ldcg(h + i); }, kBins, p.kb - 1, true,
                ws, ws + 40);
      if (threadIdx.x == 0) {
        uint32_t* bw = p.band + b * kBandWords;
        bw[kSat] = 1;
        bw[kC1] = ws[40];
        bw[kAbove1] = ws[41];
      }
      __syncthreads();
    }
  }
  grid_sync(p.bar);

  bool any_sat = false;
  for (int b = 0; b < p.nbands; ++b) any_sat |= ld_band(p, b, kSat) != 0;
  if (any_sat) {
    // the cutoff bins' crossings by their low 16 bits
    for (int d = blockIdx.x; d < p.ndm; d += gridDim.x) {
      const int b = d / p.dmb;
      if (!ld_band(p, b, kSat)) continue;
      const unsigned c1 = ld_band(p, b, kC1);
      uint32_t* h2 = p.hist2 + (size_t)b * kBins;
      const float2 st = p.rowstat[d];
      stage_row(p, d, st.x, buf);
      row_snr(p, d, st.x, st.y, buf, [&](int, int, float v) {
        if (v > p.thresh) {
          const unsigned u = __float_as_uint(v);
          if ((u >> 16) == c1) agg_inc(h2 + (u & 0xFFFFu));
        }
      });
    }
    grid_sync(p.bar);
    // v*, the kb-th value, and how many equal to it are kept
    for (int b = blockIdx.x; b < p.nbands; b += gridDim.x) {
      if (!ld_band(p, b, kSat)) continue;
      const unsigned need = p.kb - ld_band(p, b, kAbove1);
      const uint32_t* h = p.hist2 + (size_t)b * kBins;
      find_rank([&](int i) { return __ldcg(h + i); }, kBins, need - 1, true,
                ws, ws + 40);
      if (threadIdx.x == 0) {
        uint32_t* bw = p.band + b * kBandWords;
        bw[kVstar] = (ld_band(p, b, kC1) << 16) | ws[40];
        bw[kNeedEq] = need - ws[41];
      }
      __syncthreads();
    }
    grid_sync(p.bar);
  }

  // the kept crossings to their band's items
  const long long wstride = (long long)p.dmb * p.ntf;
  for (int d = blockIdx.x; d < p.ndm; d += gridDim.x) {
    const int b = d / p.dmb;
    const bool sat = ld_band(p, b, kSat) != 0;
    const unsigned vstar = sat ? ld_band(p, b, kVstar) : 0u;
    const unsigned need_eq = sat ? ld_band(p, b, kNeedEq) : 0u;
    uint32_t* bw = p.band + b * kBandWords;
    unsigned long long* items = p.items + (size_t)b * p.cap;
    const long long rowbase = (long long)(d - b * p.dmb) * p.ntf + p.skip;
    const float2 st = p.rowstat[d];
    stage_row(p, d, st.x, buf);
    row_snr(p, d, st.x, st.y, buf, [&](int k, int t, float v) {
      if (v > p.thresh) {
        const unsigned u = __float_as_uint(v);
        if (!sat || u > vstar ||
            (u == vstar && atomicAdd(bw + kTies, 1u) < need_eq)) {
          const unsigned idx = (unsigned)(k * wstride + rowbase + t);
          const unsigned pos = atomicAdd(bw + kItems, 1u);
          items[pos] = ((unsigned long long)u << 32) | (0xFFFFFFFFu - idx);
        }
      }
    });
  }
  grid_sync(p.bar);

  // each band's items in order (a bitonic sort of their keys, descending:
  // S/N, then the flat index ascending), in shared memory where they fit
  const int row1 = p.nbands * p.kb + 1;
  const size_t room = (size_t)(p.P + p.ch) * sizeof(float);
  for (int b = blockIdx.x; b < p.nbands; b += gridDim.x) {
    const int n = (int)ld_band(p, b, kItems);
    const int m = pow2_at_least(max(n, 1));
    unsigned long long* src = p.items + (size_t)b * p.cap;
    unsigned long long* a = (size_t)m * 8 <= room
                                ? reinterpret_cast<unsigned long long*>(buf)
                                : src;
    for (int i = threadIdx.x; i < m; i += kThreads)
      a[i] = i < n ? __ldcg(src + i) : 0ull;
    __syncthreads();
    for (int size = 2; size <= m; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < m / 2; i += kThreads) {
          const int lo = 2 * i - (i & (stride - 1));
          const int hi = lo + stride;
          const bool desc = (lo & size) == 0;
          const unsigned long long x = a[lo], y = a[hi];
          if ((x < y) == desc) {
            a[lo] = y;
            a[hi] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < p.kb; i += kThreads) {
      unsigned bits = kNegInf, idx = 0;
      if (i < n) {
        const unsigned long long key = a[i];
        bits = (unsigned)(key >> 32);
        idx = 0xFFFFFFFFu - (unsigned)key;
      }
      p.out[b * p.kb + i] = (int32_t)bits;
      p.out[row1 + b * p.kb + i] = (int32_t)idx;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned total = 0;
    for (int b = 0; b < p.nbands; ++b) total += ld_band(p, b, kTotal);
    p.out[row1 - 1] = (int32_t)total;
    p.out[2 * row1 - 1] = 0;
  }
}

// ---------------------------------------------------------------- host
// ip: ndm, nt, skip, ntf, nw, step, nbands, kb; fp: sigma (0: measured),
// thresh, scale[nw]
int make_params(const long long* ip, const float* fp, const void* dmt,
                void* ws, void* out, Params* p) {
  p->dmt = (const float*)dmt;
  p->ndm = (int)ip[0];
  p->nt = (int)ip[1];
  p->skip = (int)ip[2];
  p->ntf = (int)ip[3];
  p->nw = (int)ip[4];
  p->step = (int)ip[5];
  p->nbands = (int)ip[6];
  p->kb = (int)ip[7];
  if (p->nw < 1 || p->nw > kMaxW || p->nt < 1 || p->ndm < 1 ||
      p->nbands < 1 || p->ndm % p->nbands || p->kb < 1 || p->step < 1)
    return (int)cudaErrorInvalidValue;
  p->dmb = p->ndm / p->nbands;
  p->cap = pow2_at_least(p->kb);
  p->nsub = (p->nt + p->step - 1) / p->step;
  const int H = (1 << (p->nw - 1)) - 1;
  p->P = (H + 3) / 4 * 4;
  p->sigma = fp[0];
  p->thresh = fp[1];
  unsigned tb;
  memcpy(&tb, fp + 1, 4);
  p->lo = tb >> 16;
  for (int k = 0; k < kMaxW; ++k) p->scale[k] = k < p->nw ? fp[2 + k] : 0.f;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  // a whole row where pass 1 holds it, else chunks behind their halo
  p->whole = 1;
  p->ch = p->nt;
  if (smem1(*p) > (size_t)optin) {
    p->whole = 0;
    p->ch = kChunk;
  }
  const Layout L = layout(p->ndm, p->nbands, p->cap);
  char* w = (char*)ws;
  p->hist1 = (uint32_t*)(w + L.hist1);
  p->hist2 = (uint32_t*)(w + L.hist2);
  p->band = (uint32_t*)(w + L.band);
  p->bar = (uint32_t*)(w + L.bar);
  p->rowstat = (float2*)(w + L.rowstat);
  p->items = (unsigned long long*)(w + L.items);
  p->out = (int32_t*)out;
  return 0;
}

}  // namespace

// the workspace's bytes for ip (as vf_boxcar_stats takes it)
extern "C" long long vf_boxcar_topk_workspace(const long long* ip) {
  const int ndm = (int)ip[0], nbands = (int)ip[6], kb = (int)ip[7];
  return (long long)layout(ndm, nbands, pow2_at_least(kb)).bytes;
}

extern "C" int vf_boxcar_stats(const void* dmt, const long long* ip,
                               const float* fp, void* ws, void* stream) {
  Params p;
  int rc = make_params(ip, fp, dmt, ws, nullptr, &p);
  if (rc) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ws, 0, layout(p.ndm, p.nbands, p.cap)
                                             .zero_bytes, s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem1(p);
  e = cudaFuncSetAttribute(boxcar_stats_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  boxcar_stats_kernel<<<p.ndm, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int vf_topk_select(const void* dmt, const long long* ip,
                              const float* fp, void* ws, void* out,
                              void* stream) {
  Params p;
  int rc = make_params(ip, fp, dmt, ws, out, &p);
  if (rc) return rc;
  const size_t smem = smem2(p);
  cudaError_t e = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms < p.ndm ? per_sm * sms : p.ndm;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)topk_kernel, dim3(grid),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
