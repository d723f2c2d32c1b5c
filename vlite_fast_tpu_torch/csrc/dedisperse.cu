// Two-stage subband dedispersion, hand-written for Hopper (sm_90a).
// Called through ctypes from ops/dedisperse_pallas.py: dedisperse_pallas
// (an f32 filterbank) and dedisperse_pallas_packed (the gulp's packed
// 2-bit rows) through vf_dedisp_stage1/2, and the roll+select engine
// dedisperse_pallas_rollsel through vf_rollsel_stage1/2.
//
// Replaces the TPU kernels vlite_fast_tpu/ops/dedisperse_pallas.py:
// dedisperse_pallas (bodies _stage1_fold_kernel and _stage2_fold_kernel)
// together with the passes around it there (the zap, the lane-major
// relayout and the refold), and dedisperse_pallas_rollsel (bodies
// _stage1_kernel and _stage2_kernel).  Both compute, as the port's
// ops/dedisperse.dedisperse does:
//
//   fbz      = fb * chan_weights  (packed: the dequantize LUT value of each
//              2-bit level, channels fastest, LSB first, times the weight)
//   stage 1: y[b, s, t] = sum_{c in s} fbz[t + rel[b, c], c]
//            for t < t1_len = ntime_out + max_sub_delay
//   stage 2: out[d, t] = sum_s y[d / per_batch, s, t + sub_delays[d, s]]
//
// and they differ only where a row lies past the input and in stage 2's
// order of sums.  The fold reads row ntime - 1 there (its plain version's
// clamp) and sums the subbands in order from zero: allclose to the plain
// version's torch sums, not bit-equal.  The roll+select engine reads zeros
// there and sums each chunk of sc subbands in order from zero, then adds
// the chunk sums in order: the adds of dedisperse_rollsel_plain in its
// order, so the two are bit-equal.  Stage 1 sums a subband's channels in
// order from zero in both.
//
// What bounds it: the loads that feed the adds.  At the production gulp
// (27225 rows x 4096 channels, 128 batches of 38 trials, nsub 128, 15360
// samples out) stage 1 makes ~14.2 G adds (t1_len 27117 x 32 channels x
// 128 batches x 128 subbands) and stage 2 ~9.6 G; the shifts are data
// (the delay tables), so a value loaded into a register serves one add,
// and the pace is shared-memory loads (one 4-byte word per lane per clock
// per SM, ~7.4 T/s on 132 SMs: ~3.2 ms for both stages).  Device memory
// moves the packed gulp (28 MB) or the filterbank (446 MB), the y plane
// (nbatch x nsub x t1_len f32, 1.78 GB, written once and read once) and
// the output (0.3 GB).
//
//   stage 1        one block per (time tile of 512 samples, subband): it
//                  stages the subband's w channels for the tile plus the
//                  in-subband delay halo in shared memory once (from the
//                  packed rows: unpack, LUT, zap, one 8-byte word per row
//                  for 32 channels; or from the time-major filterbank:
//                  zap, a float at a time for the fold, 16 bytes at a time
//                  for rollsel_stage1), the rows at an odd stride so the 32
//                  lanes of a warp (neighbouring t, one channel) hit 32
//                  banks, then walks all nbatch batches from there: each
//                  thread sums 2 samples, and reads four channels' delays
//                  with one 16-byte load (~1.1 loads per add; 2 blocks of
//                  8 warps per SM, which beat 4 samples a thread at 4 warps).
//   stage 2        one block of 8 warps per (time tile of 32 x kRows
//                  samples, up to 8 x kTrials trials of one batch): per
//                  group of 16 subbands it stages
//                  each subband's span [t0 + min_k sd[k, s], t0 + tile +
//                  max_k sd[k, s]) of y in shared memory (the trials of a
//                  batch differ by at most sub_spread samples there, 161 at
//                  production), with cp.async into a ring of kRing buffers
//                  so the next groups land while this one is summed, and
//                  every trial reads it from there; a warp holds kTrials
//                  trials x 32 x kRows samples (kRows a lane) in registers,
//                  so each delay it reads serves kRows adds.  stage2_kernel
//                  (the fold): 16 samples x 5 trials a thread, 80 sums under
//                  the 128 registers that 2 blocks of 256 threads an SM
//                  leave; 4-byte copies into 2 buffers.  rollsel_stage2
//                  keeps a chunk's sums and the sums of the chunks before it
//                  (a chunk ends at every sc-th subband, whatever the
//                  staging group), so 8 samples x 5 trials: 80 floats again,
//                  each delay serving 8 adds; each span starts at the 16-byte
//                  boundary before it, so 16-byte copies stage it, into 3
//                  buffers.
//
// The y plane is not kept in L2 (a batch's y is 13.9 MB):
// stage 2 of an output tile reads y up to max_sub_delay (11757 at
// production) samples past it, and staging a subband tile once for all
// 128 batches is what makes stage 1's staging free; cutting the batches
// into L2-sized groups would stage (and unpack) every tile once per group.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS1Threads = 256;
constexpr int kS1Rows = 2;                      // samples per thread
constexpr int kS1T = kS1Threads * kS1Rows;      // samples per tile
constexpr int kS2Threads = 256;
constexpr int kS2Cols = 32;                     // sample columns (a warp)
constexpr int kS2Groups = kS2Threads / kS2Cols; // trial groups per block
constexpr int kS2Sub = 16;                      // subbands staged at once
// stage 2's samples and trials per thread, its staging (16-byte copies or
// 4-byte) and its ring of staged groups: the fold's, the roll+select's
constexpr int kFoldRows = 16, kFoldTrials = 5;
constexpr int kRsRows = 8, kRsTrials = 5;
constexpr bool kRsVec16 = true;
constexpr int kRsRing = 3;
constexpr size_t kSmemMax = 232448;             // a block's shared memory

struct S1Args {
  const void* in;       // f32 (ntime, >= nchan) or u8 (ntime, row bytes)
  long long row;        // elements (floats or bytes) per input row
  int ntime, nchan, w, nsub, nbatch, halo, t1_len, stride;
  int wide;             // rows aligned for one load of a subband's 32
                        // channels per row (packed: 8-byte words) or
                        // per 4 channels (f32: 16-byte words)
  float lut0, lut1, lut2, lut3;   // the 2-bit levels' values (packed)
  const float* cw;      // (nchan,) zap weights
  const int* rel;       // (nbatch, nchan) in-subband delays, 0..halo
  float* y;             // (nbatch, nsub, t1_len)
};

// W: channels per subband known at compile time (0: runtime A.w);
// kZeroTail: rows past ntime read zeros (else row ntime - 1); kF32x4: f32
// rows staged with 16-byte loads where W is 32 and A.wide
template <bool kPacked, int W, bool kZeroTail, bool kF32x4>
__device__ __forceinline__ void stage1_body(const S1Args& A, int* s1_smem) {
  const int w = W > 0 ? W : A.w;
  const int stride = W > 0 ? (W | 1) : A.stride;
  const int rows = kS1T + A.halo;
  int* rs = s1_smem;                                    // (nbatch, w)
  float* tile = (float*)(s1_smem + A.nbatch * w);       // (rows, stride)
  const int s = blockIdx.y, c0 = s * w, t0 = blockIdx.x * kS1T;
  for (int i = threadIdx.x; i < A.nbatch * w; i += blockDim.x) {
    const int b = i / w, c = i - b * w;
    rs[i] = A.rel[(long long)b * A.nchan + c0 + c];
  }
  auto lut = [&](unsigned lev) {
    return lev == 0 ? A.lut0 : lev == 1 ? A.lut1 : lev == 2 ? A.lut2 : A.lut3;
  };
  if (kPacked && W == 32 && A.wide) {
    // a thread per row: one 8-byte load, then its 32 channels (the lanes
    // of a warp on neighbouring rows hit 32 banks at each channel)
    float cw[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) cw[c] = __ldg(A.cw + c0 + c);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      if (kZeroTail && t0 + r >= A.ntime) {
#pragma unroll
        for (int c = 0; c < 32; ++c) tile[r * stride + c] = 0.0f;
        continue;
      }
      const long long t = min(t0 + r, A.ntime - 1);   // the plain clamp
      const uint64_t word = __ldg(
          (const unsigned long long*)((const uint8_t*)A.in + t * A.row) +
          s);
#pragma unroll
      for (int c = 0; c < 32; ++c)
        tile[r * stride + c] =
            __fmul_rn(lut((unsigned)(word >> (2 * c)) & 3u), cw[c]);
    }
  } else if (kF32x4 && !kPacked && W == 32 && A.wide) {
    // a thread per (row, 4 channels 4q..4q+3): one 16-byte load (the 32
    // lanes of a warp on 4 rows x 8 words hit 32 banks at each channel)
    const int q = threadIdx.x & 7;
    const float4 cw = __ldg((const float4*)(A.cw + c0) + q);
    for (int r = threadIdx.x >> 3; r < rows; r += blockDim.x >> 3) {
      float* d = tile + r * stride + 4 * q;
      if (kZeroTail && t0 + r >= A.ntime) {
        d[0] = d[1] = d[2] = d[3] = 0.0f;
        continue;
      }
      const long long t = min(t0 + r, A.ntime - 1);   // the plain clamp
      const float4 v =
          __ldg((const float4*)((const float*)A.in + t * A.row + c0) + q);
      d[0] = __fmul_rn(v.x, cw.x);
      d[1] = __fmul_rn(v.y, cw.y);
      d[2] = __fmul_rn(v.z, cw.z);
      d[3] = __fmul_rn(v.w, cw.w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w, ch = c0 + c;
      if (kZeroTail && t0 + r >= A.ntime) {
        tile[r * stride + c] = 0.0f;
        continue;
      }
      const long long t = min(t0 + r, A.ntime - 1);   // the plain clamp
      const float v =
          kPacked ? lut((((const uint8_t*)A.in)[t * A.row + (ch >> 2)] >>
                         (2 * (ch & 3))) & 3u)
                  : ((const float*)A.in)[t * A.row + ch];
      tile[r * stride + c] = __fmul_rn(v, A.cw[ch]);
    }
  }
  __syncthreads();
  const int i0 = threadIdx.x;
  const int nt = min(kS1T, A.t1_len - t0);
  for (int b = 0; b < A.nbatch; ++b) {
    const int* rb = rs + b * w;
    float acc[kS1Rows];
#pragma unroll
    for (int j = 0; j < kS1Rows; ++j) acc[j] = 0.0f;
    // one channel: its delay, then kS1Rows samples
    auto add = [&](int c, int r) {
      const float* col = tile + (i0 + r) * stride + c;
#pragma unroll
      for (int j = 0; j < kS1Rows; ++j)
        acc[j] = __fadd_rn(acc[j], col[j * kS1Threads * stride]);
    };
    if constexpr (W > 0 && W % 4 == 0) {
      // four delays per shared-memory load (the table's rows are 16-byte
      // aligned)
#pragma unroll 2
      for (int c = 0; c < W; c += 4) {
        const int4 r = *(const int4*)(rb + c);
        add(c, r.x);
        add(c + 1, r.y);
        add(c + 2, r.z);
        add(c + 3, r.w);
      }
    } else {
#pragma unroll 8
      for (int c = 0; c < w; ++c) add(c, rb[c]);
    }
    float* yo = A.y + ((long long)b * A.nsub + s) * A.t1_len + t0;
#pragma unroll
    for (int j = 0; j < kS1Rows; ++j)
      if (i0 + j * kS1Threads < nt) yo[i0 + j * kS1Threads] = acc[j];
  }
}

template <bool kPacked, int W>
__global__ void __launch_bounds__(kS1Threads) stage1_kernel(S1Args A) {
  extern __shared__ __align__(16) int s1_smem[];
  stage1_body<kPacked, W, false, false>(A, s1_smem);
}

template <int W>
__global__ void __launch_bounds__(kS1Threads) rollsel_stage1(S1Args A) {
  extern __shared__ __align__(16) int s1_smem[];
  stage1_body<false, W, true, true>(A, s1_smem);
}

struct S2Args {
  const float* y;       // (nbatch, nsub, t1_len)
  const int* subd;      // (nbatch * per_batch, nsub)
  float* out;           // (nbatch * per_batch, ntime_out)
  int nsub, t1_len, per_batch, ntime_out;
  int sub_spread;       // see vf_dedisp_stage2
  int span;             // floats per staged subband row: tile + sub_spread
  int sc;               // kChunked: subbands per chunk (divides nsub)
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
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

// kChunked: sum each chunk of A.sc subbands from zero, then add the chunk
// sums in order (else all subbands in one sum from zero).  kVec16: stage
// with 16-byte copies, each staged row starting at a 16-byte boundary of
// y (its offset folded into the delays).  kRing: staged groups in flight.
template <int kRows, int kTrials, bool kChunked, bool kVec16, int kRing>
__device__ __forceinline__ void stage2_body(const S2Args& A,
                                            float* s2_smem) {
  constexpr int kS2T = kS2Cols * kRows;          // samples per tile
  constexpr int kS2Block = kS2Groups * kTrials;  // trials per block
  float* win = s2_smem;                          // (kRing, kS2Sub, span)
  int* off = (int*)(win + kRing * kS2Sub * A.span);  // (kS2Block, nsub)
  int* lo = off + kS2Block * A.nsub;             // (nsub,)
  const int b = blockIdx.z, k0 = blockIdx.y * kS2Block;
  const int nk = min(kS2Block, A.per_batch - k0);
  const long long d0 = (long long)b * A.per_batch + k0;
  const int t0 = blockIdx.x * kS2T;
  for (int i = threadIdx.x; i < nk * A.nsub; i += blockDim.x)
    off[i] = __ldg(A.subd + d0 * A.nsub + i);
  __syncthreads();
  const float* yb = A.y + (long long)b * A.nsub * A.t1_len;
  for (int s = threadIdx.x; s < A.nsub; s += blockDim.x) {
    int m = INT_MAX;
    for (int k = 0; k < nk; ++k) m = min(m, off[k * A.nsub + s]);
    if (kVec16)   // back to the 16-byte boundary at or before the span
      m -= (int)(((uintptr_t)(yb + (long long)s * A.t1_len + t0 + m) >> 2) &
                 3);
    lo[s] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nk * A.nsub; i += blockDim.x)
    off[i] -= lo[i % A.nsub];
  // staging group q's spans into slot q % kRing, asynchronously (zeros
  // outside the row)
  const int ngroup = (A.nsub + kS2Sub - 1) / kS2Sub;
  auto slot = [](int q) { return kRing == 2 ? (q & 1) : q % kRing; };
  auto stage = [&](int q) {
    if (q < ngroup) {
      float* buf = win + slot(q) * kS2Sub * A.span;
      const int s0 = q * kS2Sub, ns = min(kS2Sub, A.nsub - s0);
      for (int sl = 0; sl < ns; ++sl) {
        const long long t = (long long)t0 + lo[s0 + sl];
        const float* src = yb + (long long)(s0 + sl) * A.t1_len + t;
        float* dst = buf + sl * A.span;
        if constexpr (kVec16) {
          for (int u = 4 * threadIdx.x; u < A.span; u += 4 * blockDim.x) {
            if (t + u >= 0 && t + u + 4 <= A.t1_len) {
              cp_async16(dst + u, src + u);
            } else {
              for (int e = u; e < u + 4; ++e) {
                if (t + e >= 0 && t + e < A.t1_len)
                  cp_async4(dst + e, src + e);
                else
                  dst[e] = 0.0f;
              }
            }
          }
        } else {
          for (int u = threadIdx.x; u < A.span; u += blockDim.x) {
            if (t + u < A.t1_len)
              cp_async4(dst + u, src + u);
            else
              dst[u] = 0.0f;
          }
        }
      }
    }
    cp_async_commit();
  };
  const int col = threadIdx.x % kS2Cols;
  const int grp = threadIdx.x / kS2Cols;   // uniform over a warp
  float acc[kTrials][kRows];
  float tot[kTrials][kRows];               // kChunked: the chunks' sums
#pragma unroll
  for (int q = 0; q < kTrials; ++q)
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[q][j] = tot[q][j] = 0.0f;
  int in_chunk = 0;                        // subbands summed into acc
  __syncthreads();                         // lo and off are complete
  for (int q = 0; q < kRing - 1; ++q) stage(q);
  for (int q = 0; q < ngroup; ++q) {
    stage(q + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncthreads();                       // group q landed for every thread
    const float* buf = win + slot(q) * kS2Sub * A.span;
    const int s0 = q * kS2Sub, ns = min(kS2Sub, A.nsub - s0);
    for (int sl = 0; sl < ns; ++sl) {
      const float* wrow = buf + sl * A.span + col;
      const int* os = off + s0 + sl;
#pragma unroll
      for (int r = 0; r < kTrials; ++r) {
        const int k = grp + r * kS2Groups;
        if (k < nk) {
          const float* p = wrow + os[k * A.nsub];
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            acc[r][j] = __fadd_rn(acc[r][j], p[j * kS2Cols]);
        }
      }
      if constexpr (kChunked) {
        if (++in_chunk == A.sc) {            // subband s0 + sl ends a chunk
          in_chunk = 0;
#pragma unroll
          for (int r = 0; r < kTrials; ++r)
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              tot[r][j] = __fadd_rn(tot[r][j], acc[r][j]);
              acc[r][j] = 0.0f;
            }
        }
      }
    }
    __syncthreads();             // before group q + kRing overwrites it
  }
#pragma unroll
  for (int r = 0; r < kTrials; ++r) {
    const int k = grp + r * kS2Groups;
    if (k >= nk) continue;
    float* o = A.out + (d0 + k) * A.ntime_out;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int t = t0 + col + j * kS2Cols;
      if (t < A.ntime_out) o[t] = kChunked ? tot[r][j] : acc[r][j];
    }
  }
}

__global__ void __launch_bounds__(kS2Threads, 2) stage2_kernel(S2Args A) {
  extern __shared__ float s2_smem[];
  stage2_body<kFoldRows, kFoldTrials, false, false, 2>(A, s2_smem);
}

__global__ void __launch_bounds__(kS2Threads, 2) rollsel_stage2(S2Args A) {
  extern __shared__ __align__(16) float rs2_smem[];
  stage2_body<kRsRows, kRsTrials, true, kRsVec16, kRsRing>(A, rs2_smem);
}

cudaError_t launch_stage1(void (*kernel)(S1Args), const S1Args& A,
                          cudaStream_t st) {
  const size_t smem =
      ((size_t)(kS1T + A.halo) * A.stride + (size_t)A.nbatch * A.w) * 4;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((A.t1_len + kS1T - 1) / kS1T, A.nsub);
  kernel<<<grid, kS1Threads, smem, st>>>(A);
  return cudaGetLastError();
}

S1Args stage1_args(const void* in, int packed, long long row, int ntime,
                   int nchan, int nsub, const void* cw, const void* rel,
                   int nbatch, int halo, int t1_len, void* y) {
  S1Args A;
  A.in = in;
  A.row = row;
  A.ntime = ntime;
  A.nchan = nchan;
  A.w = nchan / nsub;
  A.nsub = nsub;
  A.nbatch = nbatch;
  A.halo = halo;
  A.t1_len = t1_len;
  A.stride = A.w | 1;
  A.wide = packed && row % 8 == 0 && (uintptr_t)in % 8 == 0;
  A.lut0 = A.lut1 = A.lut2 = A.lut3 = 0.0f;
  A.cw = (const float*)cw;
  A.rel = (const int*)rel;
  A.y = (float*)y;
  return A;
}

// the template arguments of the stage2_body instance that `kernel` runs
template <int kRows, int kTrials, bool kVec16, int kRing>
cudaError_t launch_stage2(void (*kernel)(S2Args), S2Args A, int nbatch,
                          cudaStream_t st) {
  constexpr int kT = kS2Cols * kRows, kBlock = kS2Groups * kTrials;
  // kVec16: up to 3 floats before the span, and whole 16-byte words
  A.span = kVec16 ? (kT + A.sub_spread + 3 + 3) / 4 * 4 : kT + A.sub_spread;
  const size_t smem = ((size_t)kRing * kS2Sub * A.span +
                       (size_t)kBlock * A.nsub + A.nsub) * 4;
  if (smem > kSmemMax || A.sub_spread < 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((A.ntime_out + kT - 1) / kT,
            (A.per_batch + kBlock - 1) / kBlock, nbatch);
  kernel<<<grid, kS2Threads, smem, st>>>(A);
  return cudaGetLastError();
}

S2Args stage2_args(const void* y, int nsub, int t1_len,
                   const void* sub_delays, int per_batch, int sub_spread,
                   int sc, int ntime_out, void* out) {
  S2Args A;
  A.y = (const float*)y;
  A.subd = (const int*)sub_delays;
  A.out = (float*)out;
  A.nsub = nsub;
  A.t1_len = t1_len;
  A.per_batch = per_batch;
  A.ntime_out = ntime_out;
  A.sub_spread = sub_spread;
  A.sc = sc;
  return A;
}

}  // namespace

// Stage 1 of the fold.  packed != 0: `in` u8 (ntime, row) 2-bit rows,
// `lut` the four levels' f32 values (host memory); else `in` f32 (ntime,
// row), row >= nchan.  cw f32 (nchan,); rel i32 (nbatch, nchan), 0 <= rel
// <= halo; y f32 (nbatch, nsub, t1_len) out.  Returns a cudaError_t.
extern "C" int vf_dedisp_stage1(const void* in, int packed, long long row,
                                int ntime, int nchan, int nsub,
                                const void* cw, const float* lut,
                                const void* rel, int nbatch, int halo,
                                int t1_len, void* y, void* stream) {
  S1Args A = stage1_args(in, packed, row, ntime, nchan, nsub, cw, rel,
                         nbatch, halo, t1_len, y);
  A.lut0 = lut[0];
  A.lut1 = lut[1];
  A.lut2 = lut[2];
  A.lut3 = lut[3];
  const cudaStream_t st = (cudaStream_t)stream;
  if (A.w == 32)
    return (int)launch_stage1(
        packed ? stage1_kernel<true, 32> : stage1_kernel<false, 32>, A, st);
  return (int)launch_stage1(
      packed ? stage1_kernel<true, 0> : stage1_kernel<false, 0>, A, st);
}

// Stage 2 of the fold.  y f32 (nbatch, nsub, t1_len); sub_delays i32
// (nbatch * per_batch, nsub), trial d in batch d / per_batch, every t +
// delay < t1_len for t < ntime_out, and within a batch the delays of a
// subband spread over at most sub_spread samples; out f32 (nbatch *
// per_batch, ntime_out).  Returns a cudaError_t.
extern "C" int vf_dedisp_stage2(const void* y, int nsub, int t1_len,
                                const void* sub_delays, int nbatch,
                                int per_batch, int sub_spread, int ntime_out,
                                void* out, void* stream) {
  return (int)launch_stage2<kFoldRows, kFoldTrials, false, 2>(
      stage2_kernel, stage2_args(y, nsub, t1_len, sub_delays, per_batch,
                                 sub_spread, nsub, ntime_out, out),
      nbatch, (cudaStream_t)stream);
}

// C1, the roll+select engine's stage 1.  fb f32 (ntime, nchan) time-major,
// unzapped; cw f32 (nchan,) the zap weights; rel i32 (nbatch, nchan), 0 <=
// rel <= halo; y f32 (nbatch, nsub, t1_len) out.  Returns a cudaError_t.
extern "C" int vf_rollsel_stage1(const void* fb, int ntime, int nchan,
                                 const void* cw, const void* rel, int nbatch,
                                 int nsub, int halo, int t1_len, void* y,
                                 void* stream) {
  S1Args A = stage1_args(fb, 0, nchan, ntime, nchan, nsub, cw, rel, nbatch,
                         halo, t1_len, y);
  A.wide = nchan % 4 == 0 && (uintptr_t)fb % 16 == 0 &&
           (uintptr_t)cw % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)launch_stage1(
      A.w == 32 ? rollsel_stage1<32> : rollsel_stage1<0>, A, st);
}

// C2, the roll+select engine's stage 2: vf_dedisp_stage2's arguments, and
// sc (divides nsub) the subbands of a chunk.  Returns a cudaError_t.
extern "C" int vf_rollsel_stage2(const void* y, int nsub, int t1_len,
                                 const void* sub_delays, int nbatch,
                                 int per_batch, int sub_spread, int sc,
                                 int ntime_out, void* out, void* stream) {
  if (sc < 1 || nsub % sc) return (int)cudaErrorInvalidValue;
  return (int)launch_stage2<kRsRows, kRsTrials, kRsVec16, kRsRing>(
      rollsel_stage2, stage2_args(y, nsub, t1_len, sub_delays, per_batch,
                                  sub_spread, sc, ntime_out, out),
      nbatch, (cudaStream_t)stream);
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
