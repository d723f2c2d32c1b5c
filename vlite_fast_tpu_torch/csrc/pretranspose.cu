// The Cooley-Tukey-major relayout of one second, hand-written for Hopper
// (sm_90a).  Called through ctypes from
// ops/megakernel.py:pallas_pretranspose; the launch (slot bytes, shared
// memory, grid) is planned here (plan below).
//
// Replaces the TPU kernel vlite_fast_tpu/ops/megakernel.py:
// pallas_pretranspose (body _pretranspose_kernel): the raw second
// (npol, nsamp) u8 becomes (nseg, npol * ffts * 128, 128) tiles, one per
// (segment, pol, frame), where sample n = m1 * n2 + m2 of the frame sits
// at row m2, lane m1 and rows m2 >= n2, lanes m1 >= n1 are zero.  The
// output is u8 (the bytes, identical to pretranspose_u8) or bf16 (the
// converted voltages u / 128 - 1, u == 0 -> 0, exact in bf16).
//
// What bounds it: memory.  A production second reads 256 MB and writes
// 336 MB (u8) or 671 MB (bf16): 0.177 / 0.277 ms at 3.35 TB/s.  The TPU
// kernel transposes on the MXU by an identity product; here the transpose
// is the order of shared-memory reads.  Design (bulk.cuh):
//   - persistent blocks (the grid fills the SMs), each walking a
//     contiguous run of tiles, whose frames are contiguous in the raw
//     second;
//   - staging: a ring of kSlots frame slots.  Warp 0 brings frame k +
//     kSlots - 1 in while frame k is transposed: one bulk copy
//     (cp.async.bulk, completion on the slot's mbarrier) of the 16-byte
//     aligned span inside the frame, and the < 16 bytes before and after
//     it copied by its lanes.  A frame keeps its device-memory alignment
//     in the slot (byte i at slot + (address & 15) + i), so the span lines
//     up on both sides for every nfft (production frames start 4-byte
//     aligned, nfft 630 gives 2);
//   - transpose: lane (m2, c) of a warp reads the 16 (u8) or 8 (bf16) m1
//     of its row from the staged frame, byte loads at stride n2 (no bank
//     conflict for odd n2, the production 125: the lanes' words fall in
//     distinct banks), packs them (bf16: converted in registers) and
//     writes 16 bytes of the tile row; lanes of one row write one 128-byte
//     run of the tile buffer;
//   - stores: the tile leaves in one bulk store (16 KB u8, 32 KB bf16)
//     from one of kBufs tile buffers; its pad rows and lanes are zeroed
//     once when the block starts and never written, so every tile only
//     writes its n2 x n1 corner.  A buffer is rewritten once its store has
//     read it (wait_group.read), so the store of tile k overlaps the
//     transpose of tile k + 1 and the loads of the next frames.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 3;    // frames in flight
constexpr int kBufs = 2;     // tile buffers
constexpr int kLane = 128;

struct PreParams {
  long long nsamp;  // samples per pol
  long long ntile;  // nseg * npol * ffts
  int npol, nfft, n1, n2, ffts;
  int slot;         // bytes of a frame slot: 16-byte multiple >= nfft + 15
};

__device__ __forceinline__ const uint8_t* frame_src(const PreParams& P,
                                                    const uint8_t* raw,
                                                    long long tile) {
  const int nb = P.npol * P.ffts;
  const long long s = tile / nb;
  const int b = (int)(tile - s * nb);
  const int p = b / P.ffts, t = b - p * P.ffts;
  return raw + (long long)p * P.nsamp + (s * P.ffts + t) * P.nfft;
}

// Warp 0: frame `tile` into `slot`: byte i at
// slot[ph + i], ph = address & 15; head bytes before the first 16-byte
// boundary and tail bytes after the last one by the lanes, the nvec
// 16-byte chunks between by one bulk copy onto the slot's mbarrier.
__device__ __forceinline__ void issue_frame(const PreParams& P,
                                            const uint8_t* raw,
                                            long long tile, uint8_t* slot,
                                            uint64_t* bar, int lane) {
  const uint8_t* src = frame_src(P, raw, tile);
  const int ph = (int)((uintptr_t)src & 15);
  const int head = min((16 - ph) & 15, P.nfft);
  const int nvec = (P.nfft - head) >> 4;
  const int tail = head + (nvec << 4);
  uint8_t* dst = slot + ph;
  if (lane == 0) {
    bulk::mbar_expect_tx(bar, (uint32_t)nvec << 4);
    if (nvec) bulk::load(dst + head, src + head, (uint32_t)nvec << 4, bar);
  }
  for (int i = lane; i < head + P.nfft - tail; i += 32) {
    const int j = i < head ? i : tail + i - head;
    dst[j] = src[j];
  }
  bulk::fence_async_smem();   // before a later bulk copy into this slot
}

__device__ __forceinline__ uint4 pack16(const uint32_t (&v)[16], uint8_t) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = v[4 * j] | v[4 * j + 1] << 8 | v[4 * j + 2] << 16 |
           v[4 * j + 3] << 24;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// u / 128 - 1 (u == 0 -> 0) as bf16 bits: exact in f32 and in bf16, so
// the top half of the f32 is the bf16
__device__ __forceinline__ uint32_t conv_bf16(uint32_t u) {
  const float f = __fmaf_rn((float)u, 0.0078125f, -1.0f);
  return u ? __float_as_uint(f) >> 16 : 0u;
}

__device__ __forceinline__ uint4 pack16(const uint32_t (&v)[8], uint16_t) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = conv_bf16(v[2 * j]) | conv_bf16(v[2 * j + 1]) << 16;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// T: uint8_t (the bytes) or uint16_t (bf16 bits)
template <class T>
__global__ void __launch_bounds__(kThreads)
    pretranspose_kernel(PreParams P, const uint8_t* __restrict__ raw,
                        T* __restrict__ out) {
  constexpr int kTile = kLane * kLane * (int)sizeof(T);   // bytes
  constexpr int kPer = 16 / (int)sizeof(T);   // m1 per lane (16 bytes out)
  constexpr int kLpr = kLane / kPer;          // lanes per tile row
  constexpr int kRows = 32 / kLpr;            // rows per warp step
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* tiles = smem;                                // kBufs tiles
  uint8_t* slots = smem + kBufs * kTile;                // kSlots frames
  uint64_t* bars = (uint64_t*)(slots + kSlots * P.slot);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = blockIdx.x * P.ntile / gridDim.x;
  const int nk = (int)((blockIdx.x + 1) * P.ntile / gridDim.x - t0);

  for (int i = tid; i < kBufs * kTile / 16; i += kThreads)
    ((uint4*)tiles)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int q = 0; q < kSlots; ++q) bulk::mbar_init(&bars[q], 1);
    bulk::fence_mbar_init();
  }
  bulk::fence_async_smem();     // the zeroed pads, before the bulk stores
  __syncthreads();
  if (warp == 0)
    for (int k = 0; k < kSlots - 1 && k < nk; ++k)
      issue_frame(P, raw, t0 + k, slots + k * P.slot, &bars[k], lane);

  const int c = lane % kLpr, m1_0 = c * kPer;
  for (int k = 0; k < nk; ++k) {
    const int q = k % kSlots;
    uint8_t* tile = tiles + (k % kBufs) * kTile;
    if (tid == 0 && k >= kBufs) bulk::wait_read<kBufs - 1>();
    __syncthreads();   // tile buffer free; frame k - 1's slot read
    const int kn = k + kSlots - 1;
    if (warp == 0 && kn < nk)
      issue_frame(P, raw, t0 + kn, slots + (kn % kSlots) * P.slot,
                  &bars[kn % kSlots], lane);
    bulk::mbar_wait(&bars[q], (uint32_t)(k / kSlots) & 1u);
    const uint8_t* fr =
        slots + q * P.slot + ((uintptr_t)frame_src(P, raw, t0 + k) & 15);
    if (m1_0 < P.n1) {
      const bool whole = m1_0 + kPer <= P.n1;
      for (int m2 = warp * kRows + lane / kLpr; m2 < P.n2;
           m2 += kWarps * kRows) {
        const uint8_t* col = fr + m1_0 * P.n2 + m2;
        uint32_t v[kPer];
        if (whole) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) v[i] = col[i * P.n2];
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            v[i] = m1_0 + i < P.n1 ? col[i * P.n2] : 0u;
        }
        *(uint4*)(tile + (m2 * kLane + m1_0) * (int)sizeof(T)) =
            pack16(v, T());
      }
    }
    bulk::fence_async_smem();   // the tile's writes, before its bulk store
    __syncthreads();
    if (tid == 0) {
      bulk::store(out + (t0 + k) * (kLane * kLane), tile, kTile);
      bulk::commit();
    }
  }
  if (tid == 0) bulk::wait_all();
}

// The launch for ntile tiles of nfft-sample frames: kSlots slots of
// nfft + 15 bytes rounded up to 16, kBufs tile buffers and an mbarrier a
// slot; as many resident blocks an SM as their shared memory, threads and
// registers allow, persistent (at most one a tile): block b walks tiles
// [b ntile / grid, (b + 1) ntile / grid).
struct Plan {
  int slot, smem, grid;
};

template <class T>
cudaError_t plan(int nfft, long long ntile, Plan* p) {
  p->slot = (nfft + 15 + 15) / 16 * 16;
  p->smem = kBufs * kLane * kLane * (int)sizeof(T) + kSlots * p->slot +
            8 * kSlots;
  cudaError_t e = cudaFuncSetAttribute(
      pretranspose_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p->smem);
  int dev = 0, nsm = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pretranspose_kernel<T>, kThreads, p->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || ntile < 1) return cudaErrorInvalidConfiguration;
  p->grid = (int)(ntile < (long long)nsm * per_sm ? ntile
                                                   : (long long)nsm * per_sm);
  return cudaSuccess;
}

template <class T>
cudaError_t launch(const PreParams& P0, const void* raw, void* out,
                   cudaStream_t st) {
  Plan pl;
  cudaError_t e = plan<T>(P0.nfft, P0.ntile, &pl);
  if (e != cudaSuccess) return e;
  PreParams P = P0;
  P.slot = pl.slot;
  pretranspose_kernel<T><<<pl.grid, kThreads, pl.smem, st>>>(
      P, (const uint8_t*)raw, (T*)out);
  return cudaGetLastError();
}

}  // namespace

// ip (int64): npol, nsamp, nfft, n1, n2, seg_per_sec, out_bf16.
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
  if (P.npol < 1 || P.nfft < 1 || nseg < 1 || P.n1 * P.n2 != P.nfft ||
      P.n1 > kLane || P.n2 > kLane)
    return (int)cudaErrorInvalidValue;
  P.ffts = (int)(P.nsamp / nseg / P.nfft);
  P.ntile = (long long)nseg * P.npol * P.ffts;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(ip[6] ? launch<uint16_t>(P, raw, out, st)
                     : launch<uint8_t>(P, raw, out, st));
}

// The grid vf_pretranspose launches for ntile tiles of nfft-sample frames
// on the current device (u8 or bf16 tiles), or minus a cudaError_t.
extern "C" int vf_pretranspose_grid(int nfft, long long ntile, int bf16) {
  Plan pl;
  const cudaError_t e = bf16 ? plan<uint16_t>(nfft, ntile, &pl)
                             : plan<uint8_t>(nfft, ntile, &pl);
  return e == cudaSuccess ? pl.grid : -(int)e;
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
