// The Cooley-Tukey-major relayout of one second, hand-written for Hopper
// (sm_90a).  Called through ctypes from
// ops/megakernel.py:pallas_pretranspose.
//
// Replaces the TPU kernel vlite_fast_tpu/ops/megakernel.py:
// pallas_pretranspose (body _pretranspose_kernel): the raw second
// (npol, nsamp) u8 becomes (nseg, npol * ffts * 128, 128) tiles, one per
// (segment, pol, frame), where sample n = m1 * n2 + m2 of the frame sits
// at row m2, lane m1 and rows m2 >= n2, lanes m1 >= n1 are zero.  The
// output is u8 (the bytes, identical to pretranspose_u8) or bf16 (the
// converted voltages u / 128 - 1, u == 0 -> 0, exact in bf16).
//
//   pretranspose_kernel  one block per tile: the frame's n1 * n2 bytes
//                        read coalesced into shared memory, then the tile
//                        written row by row, four lanes per thread.
//
// What bounds it: memory.  A production second reads 256 MB and writes
// 336 MB (u8) or 671 MB (bf16), ~0.2-0.3 ms at 3.35 TB/s.  The TPU kernel
// transposes on the MXU by an identity product; here the transpose is the
// shared-memory read order (stride n2 bytes, conflict-free for odd n2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct PreParams {
  long long nsamp;  // samples per pol
  int npol, nfft, n1, n2, ffts;
};

__device__ __forceinline__ void store4(uint8_t* out, const uint8_t* v) {
  *(uchar4*)out = make_uchar4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, const uint8_t* v) {
  unsigned h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(
        v[i] == 0 ? 0.0f : (float)v[i] * 0.0078125f - 1.0f));
  *(uint2*)out = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}

template <class T>
__global__ void pretranspose_kernel(PreParams P,
                                    const uint8_t* __restrict__ raw,
                                    T* __restrict__ out) {
  extern __shared__ uint8_t fr[];    // the frame, natural order
  const long long tile = blockIdx.x;
  const int nb = P.npol * P.ffts;
  const int s = (int)(tile / nb), b = (int)(tile - (long long)s * nb);
  const int p = b / P.ffts, t = b - p * P.ffts;
  const uint8_t* src =
      raw + (long long)p * P.nsamp + ((long long)s * P.ffts + t) * P.nfft;
  for (int i = threadIdx.x; i < P.nfft; i += blockDim.x) fr[i] = src[i];
  __syncthreads();
  T* dst = out + (tile << 14);
  for (int q = threadIdx.x; q < 128 * 32; q += blockDim.x) {
    const int m2 = q >> 5, m1 = (q & 31) * 4;
    uint8_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (m2 < P.n2 && m1 + i < P.n1) ? fr[(m1 + i) * P.n2 + m2] : 0;
    store4(dst + m2 * 128 + m1, v);
  }
}

}  // namespace

// ip (int64): npol, nsamp, nfft, n1, n2, seg_per_sec, out_bf16
// Device pointers: raw u8 (npol, nsamp); out u8 or bf16
// (seg_per_sec, npol * ffts * 128, 128).
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int vf_pretranspose(const long long* ip, const void* raw,
                               void* out, void* stream) {
  PreParams P;
  P.npol = (int)ip[0];
  P.nsamp = ip[1];
  P.nfft = (int)ip[2];
  P.n1 = (int)ip[3];
  P.n2 = (int)ip[4];
  const int nseg = (int)ip[5];
  P.ffts = (int)(P.nsamp / nseg / P.nfft);
  const long long ntile = (long long)nseg * P.npol * P.ffts;
  cudaStream_t st = (cudaStream_t)stream;
  if (ip[6])
    pretranspose_kernel<<<ntile, 256, P.nfft, st>>>(
        P, (const uint8_t*)raw, (__nv_bfloat16*)out);
  else
    pretranspose_kernel<<<ntile, 256, P.nfft, st>>>(P, (const uint8_t*)raw,
                                                    (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
