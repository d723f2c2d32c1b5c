// The Cooley-Tukey DFT and detect of one frame on the tensor cores, in the
// TPU kernels' split-plane bf16 arithmetic.  Used by stage_ab.cu (the
// staged chain: dft_detect_power and chain_second_plain).
//
// Same function as the JAX package's _dft_detect_body
// (vlite_fast_tpu/ops/megakernel.py:290-325) and the port's
// ops/megakernel.dft_detect_oracle, per frame of nfft = n1 * n2 samples
// (frame sample n = m1 * n2 + m2, channel k = k1 + n1 * k2):
//
//   x         = u / 128 - 1 (u == 0 -> 0), exact in bf16
//   A[k1, m2] = sum_m1 (W1hi + W1lo)[k1, m1] x[m1, m2]       two bf16 passes
//   B         = A * tw[k1, m2]                               f32
//   split B   = hi + lo, hi = bf16(B), lo = bf16(B - hi)     round to nearest even
//   pr        = sum_m2 (hi hi + lo hi + hi lo)(w2r, B.re) - (...)(w2i, B.im)
//   pi        = sum_m2 (...)(w2i, B.re) + (...)(w2r, B.im)   lo * lo dropped
//   P[k]      = pr^2 + pi^2
//
// with every product of two bf16 values exact in f32 and the sums in f32
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  The order of the f32 sums
// is the tensor cores', not XLA's; the bar is a relative error, not bits.
// Each mma starts from a zero accumulator and its 16-deep sum is added to
// the running f32 sum rounded to nearest: the tensor cores do not round
// their accumulation to nearest, and chained over a whole dot that error
// grows with the number of steps.  Stage 1's sums then come out as an f32
// matrix product's would (most of them exact), so the hi/lo split of B
// sees the same values as the plain version's; stage 2 adds each k-step's
// six terms small ones first.
//
// Layout of the work.  One block per SM walks frames (grid-stride); warp
// w owns the 16 output rows k1 = 16w .. 16w+15 (ceil(n1 / 16) warps).
// Stage 1 is C1 = W1[k1, m1] . X[m1, m2]: W1 is the A operand (constant,
// held in shared memory already in fragment order), the frame X the B
// operand (bf16 in shared memory, stored [m2][m1] so that a fragment is
// two 32-bit loads, conflict-free).  Its f32 accumulator fragments, after
// the twiddle and the hi/lo split, ARE the A fragments of stage 2
// (D[k1, k2] = B[k1, m2] . W2[m2, k2]): the intermediate never leaves the
// registers.  Stage 2's W2 planes (B operand) sit in shared memory in
// fragment order; -w2i is w2i with the sign bits flipped, which is exact.
// Stage 1 runs over m2 in passes of 32 (4 n-tiles = 2 stage-2 k-steps) so
// that its accumulators (hi and lo passes apart, 64 registers) and stage
// 2's (64) fit together.
//
// Padding: n1 rounds up to 16 (rows and the m1 depth), n2 to 16 (the m2
// depth), n2_out to 8.  The padded entries of every constant plane are
// zero and the frame's padding cells are zeroed once, so they add nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "front.cuh"

namespace dft_tc {

constexpr int kPass = 2;      // stage-2 k-steps per pass of stage 1
constexpr int kNt2Max = 8;    // stage-2 n-tiles (n2_out <= 64)
constexpr int kWordsMax = 16; // frame words (4 bytes) each thread prefetches

struct Geom {
  int n1, n2, n2_out, nchan;
  int mt;    // warps: ceil(n1 / 16) row tiles of k1
  int ks1;   // stage-1 k-steps: ceil(n1 / 16)
  int ks2;   // stage-2 k-steps: ceil(n2 / 16); stage-1 n-tiles = 2 * ks2
  int nt2;   // stage-2 n-tiles: ceil(n2_out / 8)
  int xs;    // row stride (bf16) of the frame in shared memory: 16 ks1 + 8
};

inline Geom make_geom(int nfft, int n1, int n2) {
  Geom g;
  g.n1 = n1;
  g.n2 = n2;
  g.n2_out = nfft / 2 / n1 + 1;
  g.nchan = nfft / 2 + 1;
  g.mt = (n1 + 15) / 16;
  g.ks1 = g.mt;
  g.ks2 = (n2 + 15) / 16;
  g.nt2 = (g.n2_out + 7) / 8;
  g.xs = 16 * g.ks1 + 8;
  return g;
}

// 32-bit words of the fragment-ordered constants (ops/megakernel.tc_planes)
__host__ __device__ inline long long a1_words(const Geom& g) {
  return 4LL * g.mt * g.ks1 * 32 * 4;
}
__host__ __device__ inline long long b2_words(const Geom& g) {
  return 4LL * g.ks2 * g.nt2 * 32 * 2;
}
inline size_t smem_bytes(const Geom& g) {
  return (size_t)(a1_words(g) + b2_words(g)) * 4 +
         (size_t)32 * g.ks2 * g.xs * 2;
}
// the shapes the kernel takes (checked by the host before a launch)
inline bool fits(const Geom& g, int nfft) {
  return g.mt <= 8 && g.nt2 <= kNt2Max && nfft % 4 == 0 &&
         nfft / 4 <= kWordsMax * 32 * g.mt;
}

__device__ __forceinline__ void mma(float* c, const uint4& a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// c = A B, from a zero accumulator
__device__ __forceinline__ void mma0(float* c, const uint4& a, uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// acc += c, rounded to nearest
__device__ __forceinline__ void add4(float* acc, const float* c) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = __fadd_rn(acc[r], c[r]);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// v = hi + lo as the TPU kernel splits it; returns packed (hi, lo) of a
// pair of values
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(v1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16_rn(__fsub_rn(v0, __bfloat162float(h0))),
            __float2bfloat16_rn(__fsub_rn(v1, __bfloat162float(h1))));
}

constexpr uint32_t kNeg = 0x80008000u;   // sign bits of a bf16 pair

// The kernel.  Frames f = p * nblk + j (pol p, FFT block j of the launch,
// j = s * ffts + t); `row_of` maps a frame to its row of `power` (nchan
// f32 each).  a1: uint4 [4 planes w1r_hi, w1r_lo, w1i_hi, w1i_lo][mt][ks1]
// [32 lanes]; tw: float4 [2 (re, im)][mt][2 ks2][32]; b2: uint2 [4 planes
// w2r_hi, w2r_lo, w2i_hi, w2i_lo][ks2][nt2][32].
template <class RowOf>
__global__ void __launch_bounds__(256, 1)
    dft_detect_kernel(Geom G, NaturalU8 ld, int npol, long long nblk,
                      RowOf row_of, const uint4* __restrict__ a1,
                      const float4* __restrict__ tw,
                      const uint2* __restrict__ b2, float* __restrict__ power) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sa1 = (uint4*)smem;
  uint2* sb2 = (uint2*)(smem + a1_words(G) * 4);
  __nv_bfloat16* xs =
      (__nv_bfloat16*)(smem + (a1_words(G) + b2_words(G)) * 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nthr = blockDim.x;
  const long long nframes = (long long)npol * nblk;
  const int nfft = G.n1 * G.n2;
  const int nwords = nfft / 4;
  const int xrows = 16 * G.ks2;

  for (long long i = threadIdx.x; i < a1_words(G) / 4; i += nthr) sa1[i] = a1[i];
  for (long long i = threadIdx.x; i < b2_words(G) / 2; i += nthr) sb2[i] = b2[i];
  // zero the whole frame once: its padding cells are never written again
  for (int i = threadIdx.x; i < xrows * G.xs; i += nthr)
    xs[i] = __float2bfloat16_rn(0.0f);

  // prefetch of the next frame's bytes, 4 at a time, in registers
  uint32_t pre[kWordsMax];
  auto fetch = [&](long long f) {
    const long long p = f / nblk, j = f - p * nblk;
    const uint32_t* src =
        (const uint32_t*)(ld.raw + p * ld.nsamp + j * (long long)nfft);
#pragma unroll
    for (int k = 0; k < kWordsMax; ++k) {
      const int w = threadIdx.x + k * nthr;
      if (w < nwords) pre[k] = __ldg(src + w);
    }
  };
  long long f = blockIdx.x;
  if (f < nframes) fetch(f);
  for (; f < nframes; f += gridDim.x) {
    __syncthreads();   // the previous frame's readers are done with xs
#pragma unroll
    for (int k = 0; k < kWordsMax; ++k) {
      const int w = threadIdx.x + k * nthr;
      if (w < nwords) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = 4 * w + b;
          const int m1 = n / G.n2, m2 = n - m1 * G.n2;
          xs[m2 * G.xs + m1] =
              __float2bfloat16_rn(conv_u8((uint8_t)(pre[k] >> (8 * b))));
        }
      }
    }
    __syncthreads();
    if (f + gridDim.x < nframes) fetch(f + gridDim.x);

    float pr[kNt2Max][4], pi[kNt2Max][4];
#pragma unroll
    for (int j = 0; j < kNt2Max; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[j][r] = pi[j][r] = 0.0f;

    for (int h = 0; h * kPass < G.ks2; ++h) {
      // ---- stage 1 on m2 n-tiles [2 kPass h, 2 kPass (h + 1)): the hi
      // and lo passes in accumulators of their own, added once, as the
      // TPU kernel's two dots are ----
      float arh[2 * kPass][4], arl[2 * kPass][4], aih[2 * kPass][4],
          ail[2 * kPass][4];
#pragma unroll
      for (int j = 0; j < 2 * kPass; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          arh[j][r] = arl[j][r] = aih[j][r] = ail[j][r] = 0.0f;
      for (int ks = 0; ks < G.ks1; ++ks) {
        const uint4* ap = sa1 + ((long long)warp * G.ks1 + ks) * 32 + lane;
        const long long plane = (long long)G.mt * G.ks1 * 32;
        const uint4 wrh = ap[0], wrl = ap[plane], wih = ap[2 * plane],
                    wil = ap[3 * plane];
#pragma unroll
        for (int j = 0; j < 2 * kPass; ++j) {
          const int nt = 2 * kPass * h + j;
          if (nt < 2 * G.ks2) {
            const __nv_bfloat16* xp = xs + (8 * nt + g) * G.xs + 16 * ks + 2 * t4;
            const uint32_t b0 = *(const uint32_t*)xp;
            const uint32_t b1 = *(const uint32_t*)(xp + 8);
            float c[4];
            mma0(c, wrh, b0, b1);
            add4(arh[j], c);
            mma0(c, wrl, b0, b1);
            add4(arl[j], c);
            mma0(c, wih, b0, b1);
            add4(aih[j], c);
            mma0(c, wil, b0, b1);
            add4(ail[j], c);
          }
        }
      }
      // ---- twiddle, split, stage 2 over this half's k-steps ----
#pragma unroll
      for (int q = 0; q < kPass; ++q) {
        const int ks2 = kPass * h + q;
        if (ks2 < G.ks2) {
          uint32_t prh[4], prl[4], pih[4], pil[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {        // n-tile 2 ks2 + e
            const int j = 2 * q + e;
            const long long ti =
                ((long long)warp * 2 * G.ks2 + 2 * ks2 + e) * 32 + lane;
            const float4 twr = __ldg(tw + ti);
            const float4 twi =
                __ldg(tw + ti + (long long)G.mt * 2 * G.ks2 * 32);
            const float tr[4] = {twr.x, twr.y, twr.z, twr.w};
            const float tim[4] = {twi.x, twi.y, twi.z, twi.w};
            float br[4], bi[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float ar = __fadd_rn(arh[j][r], arl[j][r]);
              const float ai = __fadd_rn(aih[j][r], ail[j][r]);
              br[r] = __fsub_rn(__fmul_rn(ar, tr[r]), __fmul_rn(ai, tim[r]));
              bi[r] = __fadd_rn(__fmul_rn(ar, tim[r]), __fmul_rn(ai, tr[r]));
            }
            // C regs (c0, c1) -> A reg 2e, (c2, c3) -> A reg 2e + 1
            split2(br[0], br[1], prh[2 * e], prl[2 * e]);
            split2(br[2], br[3], prh[2 * e + 1], prl[2 * e + 1]);
            split2(bi[0], bi[1], pih[2 * e], pil[2 * e]);
            split2(bi[2], bi[3], pih[2 * e + 1], pil[2 * e + 1]);
          }
          const uint4 rh = make_uint4(prh[0], prh[1], prh[2], prh[3]);
          const uint4 rl = make_uint4(prl[0], prl[1], prl[2], prl[3]);
          const uint4 ih = make_uint4(pih[0], pih[1], pih[2], pih[3]);
          const uint4 il = make_uint4(pil[0], pil[1], pil[2], pil[3]);
#pragma unroll
          for (int n = 0; n < kNt2Max; ++n) {
            if (n < G.nt2) {
              const uint2* bp = sb2 + ((long long)ks2 * G.nt2 + n) * 32 + lane;
              const long long plane = (long long)G.ks2 * G.nt2 * 32;
              const uint2 w2rh = bp[0], w2rl = bp[plane], w2ih = bp[2 * plane],
                          w2il = bp[3 * plane];
              // this k-step's terms from zero, the small hi-lo ones first,
              // then added to the running sums rounded to nearest
              float c[4];
              // pr = sum w2r br - w2i bi
              mma0(c, rl, w2rh.x, w2rh.y);
              mma(c, rh, w2rl.x, w2rl.y);
              mma(c, il, w2ih.x ^ kNeg, w2ih.y ^ kNeg);
              mma(c, ih, w2il.x ^ kNeg, w2il.y ^ kNeg);
              mma(c, rh, w2rh.x, w2rh.y);
              mma(c, ih, w2ih.x ^ kNeg, w2ih.y ^ kNeg);
              add4(pr[n], c);
              // pi = sum w2i br + w2r bi
              mma0(c, rl, w2ih.x, w2ih.y);
              mma(c, rh, w2il.x, w2il.y);
              mma(c, il, w2rh.x, w2rh.y);
              mma(c, ih, w2rl.x, w2rl.y);
              mma(c, rh, w2ih.x, w2ih.y);
              mma(c, ih, w2rh.x, w2rh.y);
              add4(pi[n], c);
            }
          }
        }
      }
    }
    // ---- detect and write linear channels ----
    float* out = power + row_of(f) * (long long)G.nchan;
#pragma unroll
    for (int n = 0; n < kNt2Max; ++n) {
      if (n < G.nt2) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k1 = 16 * warp + g + 8 * (r >> 1);
          const int k2 = 8 * n + 2 * t4 + (r & 1);
          const int k = k1 + G.n1 * k2;
          if (k1 < G.n1 && k2 < G.n2_out && k < G.nchan)
            out[k] = __fadd_rn(__fmul_rn(pr[n][r], pr[n][r]),
                               __fmul_rn(pi[n][r], pi[n][r]));
        }
      }
    }
  }
}

// frame f = p * nblk + j -> row (s * npol + p) * ffts + t: stage A's
// (nseg, npol * ffts, nchan)
struct SegMajor {
  int npol, ffts;
  long long nblk;
  __device__ __forceinline__ long long operator()(long long f) const {
    const long long p = f / nblk, j = f - p * nblk;
    const long long s = j / ffts, t = j - s * ffts;
    return (s * npol + p) * ffts + t;
  }
};

// frame f -> row f: the chain's (npol, nblk, nchan) power planes
struct PolMajor {
  __device__ __forceinline__ long long operator()(long long f) const {
    return f;
  }
};

template <class RowOf>
cudaError_t launch(const Geom& G, const NaturalU8& ld, int npol,
                   long long nblk, const RowOf& row_of, const void* a1,
                   const void* tw, const void* b2, void* power,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(G);
  cudaError_t e = cudaFuncSetAttribute(
      dft_detect_kernel<RowOf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, nsm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const long long nframes = (long long)npol * nblk;
  const int grid = (int)(nframes < nsm ? nframes : nsm);
  dft_detect_kernel<RowOf><<<grid, 32 * G.mt, smem, st>>>(
      G, ld, npol, nblk, row_of, (const uint4*)a1, (const float4*)tw,
      (const uint2*)b2, (float*)power);
  return cudaGetLastError();
}

}  // namespace dft_tc
