// Two-stage subband dedispersion, hand-written for Hopper (sm_90a).
// Called through ctypes from ops/dedisperse_pallas.py: dedisperse_pallas
// (an f32 filterbank) and dedisperse_pallas_packed (the gulp's packed
// 2-bit rows).
//
// Replaces the TPU kernel vlite_fast_tpu/ops/dedisperse_pallas.py:
// dedisperse_pallas (bodies _stage1_fold_kernel and _stage2_fold_kernel)
// together with the passes around it there: the zap, the lane-major
// relayout and the refold.  Same function as the port's
// ops/dedisperse.dedisperse:
//
//   fbz      = fb * chan_weights  (packed: the dequantize LUT value of each
//              2-bit level, channels fastest, LSB first, times the weight)
//   stage 1: y[b, s, t] = sum_{c in s} fbz[min(t + rel[b, c], ntime-1), c]
//            for t < t1_len = ntime_out + max_sub_delay
//   stage 2: out[d, t] = sum_s y[d / per_batch, s, t + sub_delays[d, s]]
//
// What bounds it: the loads that feed the adds.  At the production gulp
// (27225 rows x 4096 channels, 128 batches of 38 trials, nsub 128, 15360
// samples out) stage 1 makes ~14.2 G adds and stage 2 ~9.6 G; the shifts
// are data (the delay tables), so a value loaded into a register serves
// one add, and the pace is shared-memory loads (one 4-byte word per lane
// per clock per SM, ~7.4 T/s on 132 SMs: ~3.2 ms for both stages).  Device
// memory moves the packed gulp (28 MB) or the filterbank, the y plane
// (nbatch x nsub x t1_len f32, 1.78 GB, written once and read once) and
// the output (0.3 GB).
//
//   stage1_kernel  one block per (time tile of 512 samples, subband): it
//                  stages the subband's w channels for the tile plus the
//                  in-subband delay halo in shared memory once (from the
//                  packed rows: unpack, LUT, zap, one 8-byte word per row
//                  for 32 channels; or from the time-major filterbank:
//                  zap), the rows at an odd stride so the 32
//                  lanes of a warp (neighbouring t, one channel) hit 32
//                  banks, then walks all nbatch batches from there: each
//                  thread sums 2 samples, and reads four channels' delays
//                  with one 16-byte load (~1.1 loads per add; 2 blocks of
//                  8 warps per SM, which beat 4 samples a thread at 4 warps).
//   stage2_kernel  one block of 8 warps per (time tile of 512 samples, up
//                  to 40 trials of one batch): per chunk of 16 subbands it stages
//                  each subband's span [t0 + min_k sd[k, s], t0 + 512 +
//                  max_k sd[k, s]) of y in shared memory (the trials of a
//                  batch differ by at most sub_spread samples there, 161 at
//                  production), with cp.async into two buffers so the next
//                  chunk lands while this one is summed, and every trial
//                  reads it from there; a warp holds 5 trials x 512
//                  samples (16 a lane) in registers, so each delay it
//                  reads serves 16 adds.
//
// Each stage sums its terms in order from zero (channels, then subbands),
// in another order than the plain version's torch sums: allclose, not
// bit-equal.  The y plane is not kept in L2 (a batch's y is 13.9 MB):
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
constexpr int kS2Rows = 16;                     // samples per thread
constexpr int kS2T = kS2Cols * kS2Rows;         // samples per tile
constexpr int kS2Groups = kS2Threads / kS2Cols; // trial groups per block
constexpr int kS2Trials = 5;                    // trials per thread
constexpr int kS2Block = kS2Groups * kS2Trials; // trials per block
constexpr int kS2Sub = 16;                      // subbands staged at once
constexpr size_t kSmemMax = 232448;             // a block's shared memory

struct S1Args {
  const void* in;       // f32 (ntime, >= nchan) or u8 (ntime, row bytes)
  long long row;        // elements (floats or bytes) per input row
  int ntime, nchan, w, nsub, nbatch, halo, t1_len, stride;
  int row8;             // packed rows 8-byte aligned: a subband's 32
                        // channels are one 8-byte word of a row
  float lut0, lut1, lut2, lut3;   // the 2-bit levels' values (packed)
  const float* cw;      // (nchan,) zap weights
  const int* rel;       // (nbatch, nchan) in-subband delays, 0..halo
  float* y;             // (nbatch, nsub, t1_len)
};

// W: channels per subband known at compile time (0: runtime A.w)
template <bool kPacked, int W>
__global__ void __launch_bounds__(kS1Threads) stage1_kernel(S1Args A) {
  extern __shared__ __align__(16) int s1_smem[];
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
  if (kPacked && W == 32 && A.row8) {
    // a thread per row: one 8-byte load, then its 32 channels (the lanes
    // of a warp on neighbouring rows hit 32 banks at each channel)
    float cw[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) cw[c] = __ldg(A.cw + c0 + c);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long long t = min(t0 + r, A.ntime - 1);   // the plain clamp
      const uint64_t word = __ldg(
          (const unsigned long long*)((const uint8_t*)A.in + t * A.row) +
          s);
#pragma unroll
      for (int c = 0; c < 32; ++c)
        tile[r * stride + c] =
            __fmul_rn(lut((unsigned)(word >> (2 * c)) & 3u), cw[c]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w, ch = c0 + c;
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

struct S2Args {
  const float* y;       // (nbatch, nsub, t1_len)
  const int* subd;      // (nbatch * per_batch, nsub)
  float* out;           // (nbatch * per_batch, ntime_out)
  int nsub, t1_len, per_batch, ntime_out;
  int span;             // floats per staged subband row: kS2T + sub_spread
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__global__ void __launch_bounds__(kS2Threads, 2) stage2_kernel(S2Args A) {
  extern __shared__ float s2_smem[];
  float* win = s2_smem;                          // (2, kS2Sub, span)
  int* off = (int*)(win + 2 * kS2Sub * A.span);  // (kS2Block, nsub)
  int* lo = off + kS2Block * A.nsub;             // (nsub,)
  const int b = blockIdx.z, k0 = blockIdx.y * kS2Block;
  const int nk = min(kS2Block, A.per_batch - k0);
  const long long d0 = (long long)b * A.per_batch + k0;
  const int t0 = blockIdx.x * kS2T;
  for (int i = threadIdx.x; i < nk * A.nsub; i += blockDim.x)
    off[i] = __ldg(A.subd + d0 * A.nsub + i);
  __syncthreads();
  for (int s = threadIdx.x; s < A.nsub; s += blockDim.x) {
    int m = INT_MAX;
    for (int k = 0; k < nk; ++k) m = min(m, off[k * A.nsub + s]);
    lo[s] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nk * A.nsub; i += blockDim.x)
    off[i] -= lo[i % A.nsub];
  const float* yb = A.y + (long long)b * A.nsub * A.t1_len;
  // chunk q's spans into buffer q % 2, asynchronously (zeros past t1_len)
  const int nchunk = (A.nsub + kS2Sub - 1) / kS2Sub;
  auto stage = [&](int q) {
    if (q < nchunk) {
      float* buf = win + (q & 1) * kS2Sub * A.span;
      const int s0 = q * kS2Sub, ns = min(kS2Sub, A.nsub - s0);
      for (int sl = 0; sl < ns; ++sl) {
        const long long t = (long long)t0 + lo[s0 + sl];
        const float* src = yb + (long long)(s0 + sl) * A.t1_len + t;
        float* dst = buf + sl * A.span;
        for (int u = threadIdx.x; u < A.span; u += blockDim.x) {
          if (t + u < A.t1_len)
            cp_async4(dst + u, src + u);
          else
            dst[u] = 0.0f;
        }
      }
    }
    cp_async_commit();
  };
  const int col = threadIdx.x % kS2Cols;
  const int grp = threadIdx.x / kS2Cols;   // uniform over a warp
  float acc[kS2Trials][kS2Rows];
#pragma unroll
  for (int q = 0; q < kS2Trials; ++q)
#pragma unroll
    for (int j = 0; j < kS2Rows; ++j) acc[q][j] = 0.0f;
  __syncthreads();                         // lo and off are complete
  stage(0);
  for (int q = 0; q < nchunk; ++q) {
    stage(q + 1);
    cp_async_wait1();
    __syncthreads();                       // chunk q landed for every thread
    const float* buf = win + (q & 1) * kS2Sub * A.span;
    const int s0 = q * kS2Sub, ns = min(kS2Sub, A.nsub - s0);
    for (int sl = 0; sl < ns; ++sl) {
      const float* wrow = buf + sl * A.span + col;
      const int* os = off + s0 + sl;
#pragma unroll
      for (int r = 0; r < kS2Trials; ++r) {
        const int k = grp + r * kS2Groups;
        if (k < nk) {
          const float* p = wrow + os[k * A.nsub];
#pragma unroll
          for (int j = 0; j < kS2Rows; ++j)
            acc[r][j] = __fadd_rn(acc[r][j], p[j * kS2Cols]);
        }
      }
    }
    __syncthreads();                       // before chunk q + 2 overwrites it
  }
#pragma unroll
  for (int r = 0; r < kS2Trials; ++r) {
    const int k = grp + r * kS2Groups;
    if (k >= nk) continue;
    float* o = A.out + (d0 + k) * A.ntime_out;
#pragma unroll
    for (int j = 0; j < kS2Rows; ++j) {
      const int t = t0 + col + j * kS2Cols;
      if (t < A.ntime_out) o[t] = acc[r][j];
    }
  }
}

template <bool kPacked, int W>
cudaError_t launch_stage1(const S1Args& A, cudaStream_t st) {
  const size_t smem =
      ((size_t)(kS1T + A.halo) * A.stride + (size_t)A.nbatch * A.w) * 4;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stage1_kernel<kPacked, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((A.t1_len + kS1T - 1) / kS1T, A.nsub);
  stage1_kernel<kPacked, W><<<grid, kS1Threads, smem, st>>>(A);
  return cudaGetLastError();
}

}  // namespace

// Stage 1.  packed != 0: `in` u8 (ntime, row) 2-bit rows, `lut` the four
// levels' f32 values (host memory); else `in` f32 (ntime, row), row >=
// nchan.  cw f32 (nchan,); rel i32 (nbatch, nchan), 0 <= rel <= halo; y f32
// (nbatch, nsub, t1_len) out.  Returns a cudaError_t.
extern "C" int vf_dedisp_stage1(const void* in, int packed, long long row,
                                int ntime, int nchan, int nsub,
                                const void* cw, const float* lut,
                                const void* rel, int nbatch, int halo,
                                int t1_len, void* y, void* stream) {
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
  A.row8 = packed && row % 8 == 0 && (uintptr_t)in % 8 == 0;
  A.lut0 = lut[0];
  A.lut1 = lut[1];
  A.lut2 = lut[2];
  A.lut3 = lut[3];
  A.cw = (const float*)cw;
  A.rel = (const int*)rel;
  A.y = (float*)y;
  const cudaStream_t st = (cudaStream_t)stream;
  if (A.w == 32)
    return (int)(packed ? launch_stage1<true, 32>(A, st)
                        : launch_stage1<false, 32>(A, st));
  return (int)(packed ? launch_stage1<true, 0>(A, st)
                      : launch_stage1<false, 0>(A, st));
}

// Stage 2.  y f32 (nbatch, nsub, t1_len); sub_delays i32 (nbatch *
// per_batch, nsub), trial d in batch d / per_batch, every t + delay <
// t1_len for t < ntime_out, and within a batch the delays of a subband
// spread over at most sub_spread samples; out f32 (nbatch * per_batch,
// ntime_out).  Returns a cudaError_t.
extern "C" int vf_dedisp_stage2(const void* y, int nsub, int t1_len,
                                const void* sub_delays, int nbatch,
                                int per_batch, int sub_spread, int ntime_out,
                                void* out, void* stream) {
  S2Args A;
  A.y = (const float*)y;
  A.subd = (const int*)sub_delays;
  A.out = (float*)out;
  A.nsub = nsub;
  A.t1_len = t1_len;
  A.per_batch = per_batch;
  A.ntime_out = ntime_out;
  A.span = kS2T + sub_spread;
  const size_t smem = ((size_t)2 * kS2Sub * A.span +
                       (size_t)kS2Block * nsub + nsub) * 4;
  if (smem > kSmemMax || sub_spread < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((ntime_out + kS2T - 1) / kS2T,
            (per_batch + kS2Block - 1) / kS2Block, nbatch);
  stage2_kernel<<<grid, kS2Threads, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
