// The armed program's RFI front for a whole second, hand-written for
// Hopper (sm_90a).  Called through ctypes from ops/rfi_pallas.py:rfi_front.
//
// Replaces the TPU kernel vlite_fast_tpu/ops/rfi_pallas.py:rfi_front
// (body _front_kernel): u8 voltages in; masked f32 voltages, the weight
// per (pol, FFT block) and the pol-combined fine TS per window out.
//
//   rfi_front_kernel  one block per FFT block (both pols, since the gates
//                     take the max over pols): the statistics and gates
//                     of front.cuh (shared with the chain kernel's front),
//                     then the block's converted voltages written with
//                     flagged windows zeroed, its weight and its TS.
//
// What bounds it: memory.  A production second reads 256 MB of u8 and
// writes 1 GB of f32 (128M samples x 2 pols), ~0.4 ms at 3.35 TB/s; the
// statistics are ~10 flops per sample.  The TPU kernel tiled windows into
// VMEM to keep the intermediates out of HBM; here each block's
// statistics live in a few hundred bytes of shared memory and the block
// reads its 25 KB of bytes twice (the second read hits L1/L2), so device
// memory sees one read and one write.  Neighbouring threads read and
// write neighbouring samples.
//
// The cube root is cbrtf, as in the chain kernel (the TPU kernel's
// exp(log(t)/3) works around Mosaic's missing cbrt; the TS differ by a
// few ulp and the gates agree away from the threshold).

#include <cuda_runtime.h>
#include <stdint.h>

#include "front.cuh"

namespace {

struct RfiParams {
  long long nsamp;  // samples per pol
  int npol, nfft, nkurto, wpf, nblk;
  float rkurto, rwpf, dag_thresh, dag_fb_thresh, dag_inf;
  DagK kf, kb;
};

__global__ void rfi_front_kernel(RfiParams P, const uint8_t* __restrict__ raw,
                                 float* __restrict__ masked,
                                 float* __restrict__ weights,
                                 float* __restrict__ dag) {
  extern __shared__ float sm[];
  uint8_t* keep = (uint8_t*)(sm + front_smem_floats(P));
  const long long j = blockIdx.x;
  const FrontCounts c = front_block(
      P, NaturalU8{raw, P.nsamp, P.nfft}, j, sm, keep);
  const float* dags = sm + 2 * P.npol * P.wpf;
  if (threadIdx.x == 0) {
    const float wt = __fmul_rn((float)c.nkeep, P.rwpf);
    for (int p = 0; p < P.npol; ++p) weights[(long long)p * P.nblk + j] = wt;
  }
  for (int w = threadIdx.x; w < P.wpf; w += blockDim.x)
    dag[j * P.wpf + w] = dags[w];
  for (int p = 0; p < P.npol; ++p) {
    const long long base = (long long)p * P.nsamp + j * P.nfft;
    for (int i = threadIdx.x; i < P.nfft; i += blockDim.x)
      masked[base + i] = keep[i / P.nkurto] ? conv_u8(raw[base + i]) : 0.0f;
  }
}

}  // namespace

// ip (int64): npol, nsamp, nfft, nkurto
// fp (f32):   dag_thresh, dag_fb_thresh, dag_inf, kf[5], kb[5]
//             (DagK order: c1, mu1, z21, z22, z23)
// Device pointers: raw u8 (npol, nsamp); masked f32 (npol, nsamp);
// weights f32 (npol, nsamp / nfft); dag f32 (nsamp / nkurto).
// Launches on `stream`; returns cudaGetLastError() after the launch.
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
  P.rkurto = 1.0f / (float)P.nkurto;
  P.rwpf = 1.0f / (float)P.wpf;
  P.dag_thresh = fp[0];
  P.dag_fb_thresh = fp[1];
  P.dag_inf = fp[2];
  P.kf = DagK{fp[3], fp[4], fp[5], fp[6], fp[7]};
  P.kb = DagK{fp[8], fp[9], fp[10], fp[11], fp[12]};
  const size_t smem = (size_t)front_smem_floats(P) * sizeof(float) + P.wpf;
  rfi_front_kernel<<<P.nblk, 256, smem, (cudaStream_t)stream>>>(
      P, (const uint8_t*)raw, (float*)masked, (float*)weights, (float*)dag);
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
