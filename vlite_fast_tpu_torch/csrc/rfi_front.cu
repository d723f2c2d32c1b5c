// The armed program's RFI front for a whole second, hand-written for
// Hopper (sm_90a).  Called through ctypes from ops/rfi_pallas.py:rfi_front.
//
// Replaces the TPU kernel vlite_fast_tpu/ops/rfi_pallas.py:rfi_front
// (body _front_kernel): u8 voltages in; masked f32 voltages, the weight
// per (pol, FFT block) and the pol-combined fine TS per window out.
//
// What bounds it: memory.  A production second reads 256 MB of u8 and
// writes 1 GB of f32 (128M samples x 2 pols), ~0.38 ms at 3.35 TB/s; the
// statistics are ~10 flops per sample.  The TPU kernel tiled windows into
// VMEM to keep the intermediates out of HBM; here one block per FFT
// block (both pols, since the gates take the max over pols) keeps them in
// shared memory:
//   stage    the block's npol x nfft bytes (25 KB at production) copied
//            once into shared memory, 16 bytes a copy (cp.async); a row
//            keeps its alignment in device memory, so the 16-byte chunks
//            line up on both sides and only the < 16 bytes before the
//            first and after the last go one by one (a block's bytes
//            start at j*nfft, 4-byte aligned at production);
//   stats    front.cuh's window statistics from the staged bytes, one warp
//            per (pol, window), lane l summing samples l, l + 32, ... (the
//            order every front of the port uses, so the TS are bit-equal
//            to the chain's front);
//   gates    front.cuh's block_gates on one warp: lane w the D'Agostino
//            TS of window w, lane p the block TS of pol p;
//   write    the converted voltages with flagged windows zeroed as 16-byte
//            streaming stores, a float4's 4 bytes read from shared memory
//            as one word where they are 4-byte aligned (every block at
//            production) and its window's flag looked up once (the
//            window carried from one float4 to the next, no divide; a
//            float4 that straddles two windows goes sample by sample),
//            then the weight and the TS.
//
// The cube root is cbrtf, as in the chain kernel (the TPU kernel's
// exp(log(t)/3) works around Mosaic's missing cbrt; the TS differ by a
// few ulp and the gates agree away from the threshold).

#include <cuda_runtime.h>
#include <stdint.h>

#include "front.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 4 * kThreads;   // samples between a thread's stores

struct RfiParams {
  long long nsamp;  // samples per pol
  int npol, nfft, nkurto, wpf, nblk;
  int stride;          // bytes of a staged pol row (16-byte multiple)
  int step_q, step_r;  // kStep = step_q * nkurto + step_r
  float rkurto, rwpf, dag_thresh, dag_fb_thresh, dag_inf;
  DagK kf, kb;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The block's staged bytes: sample n of pol p at s[org[p] + n]
struct StagedU8 {
  const uint8_t* s;
  const int* org;
  __device__ __forceinline__ float operator()(int p, long long,
                                              int n) const {
    return conv_u8(s[org[p] + n]);
  }
};

// Shared memory: npol staged rows, front_block's floats, org (npol int),
// keep (wpf bytes)
int smem_bytes(const RfiParams& P) {
  return P.npol * P.stride + front_smem_floats(P) * (int)sizeof(float) +
         P.npol * (int)sizeof(int) + P.wpf;
}

__global__ void __launch_bounds__(kThreads)
    rfi_front_kernel(RfiParams P, const uint8_t* __restrict__ raw,
                     float* __restrict__ masked, float* __restrict__ weights,
                     float* __restrict__ dag) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* bytes = smem;
  float* sm = (float*)(smem + P.npol * P.stride);
  int* org = (int*)(sm + front_smem_floats(P));
  uint8_t* keep = (uint8_t*)(org + P.npol);
  const long long j = blockIdx.x;
  const int tid = threadIdx.x;
  for (int p = 0; p < P.npol; ++p) {
    const uint8_t* src = raw + p * P.nsamp + j * P.nfft;
    const int ph = (int)((uintptr_t)src & 15);
    uint8_t* dst = bytes + p * P.stride + ph;   // dst - ph 16-byte aligned
    const int head = min((16 - ph) & 15, P.nfft);
    const int nvec = (P.nfft - head) >> 4;
    const int tail = head + (nvec << 4);
    for (int i = tid; i < nvec; i += kThreads)
      cp_async16(dst + head + 16 * i, src + head + 16 * i);
    if (tid < head)
      dst[tid] = src[tid];
    else if (tid - head < P.nfft - tail)
      dst[tail + tid - head] = src[tail + tid - head];
    if (tid == 0) org[p] = p * P.stride + ph;
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
  __syncthreads();
  window_stats(P, StagedU8{bytes, org}, j, sm);
  __syncthreads();
  const FrontCounts c = block_gates(P, sm, keep);
  __syncthreads();
  const float* dags = sm + 2 * P.npol * P.wpf;
  if (tid == 0) {
    const float wt = __fmul_rn((float)c.nkeep, P.rwpf);
    for (int p = 0; p < P.npol; ++p) weights[(long long)p * P.nblk + j] = wt;
  }
  for (int w = tid; w < P.wpf; w += kThreads) dag[j * P.wpf + w] = dags[w];
  for (int p = 0; p < P.npol; ++p) {
    const uint8_t* b = bytes + org[p];
    float* out = masked + p * P.nsamp + j * P.nfft;
    // the samples before the first 16-byte boundary and after the last
    // whole float4, one by one
    const int head = min((int)((16 - ((uintptr_t)out & 15)) & 15) >> 2,
                         P.nfft);
    const int nvec = (P.nfft - head) >> 2;
    const int tail = head + (nvec << 2);
    if (tid < head + P.nfft - tail) {
      const int n = tid < head ? tid : tail + tid - head;
      out[n] = keep[n / P.nkurto] ? conv_u8(b[n]) : 0.0f;
    }
    // a float4's bytes as one 4-byte word where they are 4-byte aligned
    // in shared memory (every block at production)
    const bool words = ((org[p] + head) & 3) == 0;
    // this thread's float4s start at samples n = head + 4 tid + kStep i;
    // n = w nkurto + r is carried along without a divide
    int n = head + 4 * tid;
    int w = n / P.nkurto, r = n - w * P.nkurto;
    for (int i = tid; i < nvec; i += kThreads) {
      const uint32_t q =
          words ? *(const uint32_t*)(b + n)
                : b[n] | (uint32_t)b[n + 1] << 8 | (uint32_t)b[n + 2] << 16 |
                      (uint32_t)b[n + 3] << 24;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = conv_u8((uint8_t)(q >> (8 * e)));
      if (r + 3 < P.nkurto) {   // one window
        if (!keep[w]) v[0] = v[1] = v[2] = v[3] = 0.0f;
      } else {                  // straddling: the window sample by sample
        int ww = w, rr = r;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!keep[ww]) v[e] = 0.0f;
          if (++rr == P.nkurto) {
            rr = 0;
            ++ww;
          }
        }
      }
      // streaming: the masked second (1 GB) is read back only by later
      // launches
      __stcs((float4*)(out + n), make_float4(v[0], v[1], v[2], v[3]));
      n += kStep;
      w += P.step_q;
      r += P.step_r;
      if (r >= P.nkurto) {
        r -= P.nkurto;
        ++w;
      }
    }
  }
}

}  // namespace

// ip (int64): npol, nsamp, nfft, nkurto
// fp (f32):   dag_thresh, dag_fb_thresh, dag_inf, kf[5], kb[5]
//             (DagK order: c1, mu1, z21, z22, z23)
// Device pointers: raw u8 (npol, nsamp); masked f32 (npol, nsamp);
// weights f32 (npol, nsamp / nfft); dag f32 (nsamp / nkurto).  Launches
// on `stream`; returns the error of the shared-memory request (a block's
// bytes beyond the card's shared memory) or cudaGetLastError() after the
// launch.
extern "C" int vf_rfi_front(const long long* ip, const float* fp,
                            const void* raw, void* masked, void* weights,
                            void* dag, void* stream) {
  RfiParams P;
  P.npol = (int)ip[0];
  P.nsamp = ip[1];
  P.nfft = (int)ip[2];
  P.nkurto = (int)ip[3];
  P.wpf = P.nfft / P.nkurto;
  P.nblk = (int)(P.nsamp / P.nfft);
  P.stride = (P.nfft + 15 + 15) / 16 * 16;
  P.step_q = kStep / P.nkurto;
  P.step_r = kStep % P.nkurto;
  P.rkurto = 1.0f / (float)P.nkurto;
  P.rwpf = 1.0f / (float)P.wpf;
  P.dag_thresh = fp[0];
  P.dag_fb_thresh = fp[1];
  P.dag_inf = fp[2];
  P.kf = DagK{fp[3], fp[4], fp[5], fp[6], fp[7]};
  P.kb = DagK{fp[8], fp[9], fp[10], fp[11], fp[12]};
  const int smem = smem_bytes(P);
  cudaError_t e = cudaFuncSetAttribute(
      rfi_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rfi_front_kernel<<<P.nblk, kThreads, smem, (cudaStream_t)stream>>>(
      P, (const uint8_t*)raw, (float*)masked, (float*)weights, (float*)dag);
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
