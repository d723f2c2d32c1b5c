// The Cooley-Tukey DFT and detect of one frame on Hopper's warpgroup
// tensor cores (wgmma), in the TPU kernels' split-plane bf16 arithmetic,
// fed by bulk copies (cp.async.bulk, the 1-D TMA).  Used by stage_ab.cu
// (the staged chain: dft_detect_power and chain_second_plain) and by every
// layout of chain.cu: the raw second (chain_second_v2) and the
// Cooley-Tukey-major u8 or bf16 tiles (chain_second, chain_second_v4),
// both streams.  The frames come through a loader (front.cuh), which
// sets how they reach the frame tile; every loader puts the same bf16
// values at the same places there, so the three chains give the same bits.
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
// Every product of two bf16 values is exact in f32; the sums are f32 in
// the tensor cores' order.  The tensor cores do not round their
// accumulation to nearest, and chained over a whole dot that error grew
// to 2.3e-3 relative on near-zero bins, so each stage-1 k16 product
// starts from zero (scale-d = 0) and is added to the running sum with
// __fadd_rn (its sums then come out as an f32 matrix product's, most of
// them exact, and the hi/lo split of B sees the plain version's values);
// stage 2 chains each k-step's six terms, the small ones first, from zero
// and adds them rounded to nearest.
//
// What bounds it: operations.  At the production split (12500 = 100 x
// 125) a frame is ~40 MFLOP of padded bf16 products (stage 1: 4 planes of
// 128 x 128 x 112; stage 2: 12 of 128 x 64 x 128), so 20,480 frames per
// data-second take >= 0.83 ms at 989 TFLOP/s; their bytes (256 MB in,
// 512 MB of power out) 0.23 ms.  Design:
//   - one persistent block per SM walks a list of jobs (frames); the W1
//     and W2 hi/lo planes sit in shared memory for the whole launch, in
//     wgmma's no-swizzle core-matrix layout (ops/megakernel.tc_planes);
//   - one thread keeps kSlots raw frames in flight: one bulk copy of the
//     16-byte-aligned span that covers the frame (frames start only
//     4-byte aligned) into a ring slot, completion on an mbarrier; the
//     span is clamped to the buffer and the bytes outside it are read
//     from device memory by the converter, so nothing is read out of
//     bounds.  (A producer warp of its own made ptxas size the registers
//     for three warpgroups: 168 a thread, and the consumers spilled);
//   - ceil(n1 / 64) consumer warpgroups each own 64 rows k1.  Stage 1
//     runs in passes of 32 m2 columns: wgmma m64n32k16, A = a W1 plane,
//     B = the bf16 frame tile (both from shared memory).  The pass's f32
//     accumulators, after the twiddle and the hi/lo split, ARE the A
//     fragments of stage 2's wgmma m64n64k16 (A from registers, B = the
//     W2 planes; the FlashAttention-3 pattern), so the intermediate never
//     leaves the registers;
//   - the frame tile is one buffer cut in slices of 32 m2 rows: once both
//     warpgroups have read slice h of frame f (stage 1, pass h), the
//     consumers convert slice h of the next frame from its ring slot
//     while their stage-2 products of pass h run on the tensor cores;
//   - CT-major tiles (CtMajor<T>): a frame's 32-row slice is one
//     contiguous, aligned run of its tile (4 KB u8, 8 KB bf16), so the
//     ring holds slices, not frames: thread 0 brings slice h of a frame
//     into slot q % nslot (q = k npass + h, up to kCtSlots slots, at
//     least npass + 1: a pass of lead), once per pass, and each item of
//     the converter (8 m1 at one m2) is one 8- or 16-byte load.
// Shared memory at the production split: W1 93 KB, W2 64 KB, the tile 28
// KB, three 12.5 KB slots: 225 of 227 KB (CT-major: 8 4-KB u8 slices, or 5
// 8-KB bf16 ones, 220 and 223 KB).  To fit, W1 stores only its rows
// up to n1 rounded up to 8 (the rows past them that the second
// warpgroup's 64-row operand reaches read the next plane's finite values
// and give rows k1 >= n1, which are never written).  W2 stores its whole
// depth, the 32 npass columns m2 that stage 2's k-steps walk (zero past
// n2), so no descriptor reads past its plane.  A second frame tile does
// not fit beside three slots; the slice-wise overlap takes its place.  A
// 2-CTA cluster sharing the planes is no option: wgmma reads only its own
// block's shared memory.
// The twiddle (128 KB at production) stays in device memory, read in
// accumulator order (L2-resident).  Splits up to n1 = 128 whose W1 planes
// do not fit beside the rest (some with n1 >= 105 and n2 >= 113, and on
// bf16 tiles some with n1 >= 105 and n2 > 96; not the production 100 x
// 125) run split: two blocks transform each frame, one
// warpgroup and its 64 rows of W1 each.
//
// Padding: n1 rounds up to 16 in the stage-1 depth and to 64 in rows,
// n2 to 32 (passes), n2_out to 64.  The padded entries of every constant
// plane are zero and the converter writes zeros in the frame's padding,
// so they add nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bulk.cuh"
#include "front.cuh"

namespace dft_tc {

constexpr int kSlots = 3;                    // raw frames in flight
constexpr int kCtSlots = 8;                  // CT-major slices, at most
constexpr int kMaxWg = 2;                    // warpgroups (n1 <= 128)
constexpr int kThreads = 128 * kMaxWg;
constexpr int kSmemMax = 232448;             // bytes a block may use

struct Geom {
  int nfft, n1, n2, n2_out, nchan;
  int nwg;    // consumer warpgroups: ceil(n1 / 64)
  int kb1;    // stage-1 depth in 8-wide core blocks: 2 ceil(n1 / 16)
  int rg1;    // W1 rows stored, in 8-row groups: ceil(n1 / 8)
  int npass;  // stage-1 passes of 32 m2 columns: ceil(n2 / 32)
  int kb2;    // W2 depth (m2) stored, in 8-wide core blocks: 4 npass
  int ct;     // bytes of a CT-major tile's element (1, 2), 0: natural
  int slot;   // bytes of one ring slot: a raw frame, or a CT slice
  int nslot;  // ring slots: kSlots raw frames, or up to kCtSlots slices
  int split;  // 1: two blocks per frame, one warpgroup's 64 rows each
  // shared memory: byte sizes and offsets
  int w1_plane, w2_plane, tile, ring, bars, smem;
};

// ct: 0 for the raw second (NaturalU8), else the element bytes of the
// CT-major tiles (CtMajor<uint8_t> 1, CtMajor<__nv_bfloat16> 2), whose
// ring holds slices of 32 tile rows (m2) and needs npass + 1 of them: one
// pass of lead over the slice the consumers convert next
inline Geom make_geom(int nfft, int n1, int n2, int ct = 0) {
  Geom g;
  g.nfft = nfft;
  g.n1 = n1;
  g.n2 = n2;
  g.n2_out = nfft / 2 / n1 + 1;
  g.nchan = nfft / 2 + 1;
  g.nwg = (n1 + 63) / 64;
  g.kb1 = 2 * ((n1 + 15) / 16);
  g.rg1 = (n1 + 7) / 8;
  g.npass = (n2 + 31) / 32;
  g.kb2 = 4 * g.npass;
  g.ct = ct;
  g.slot = ct ? (n2 < 32 ? n2 : 32) * 128 * ct : (nfft + 15) / 16 * 16 + 16;
  g.w2_plane = 8 * g.kb2 * 128;             // 64 k2 rows x 8 kb2 m2
  for (g.split = 0; g.split < 2; ++g.split) {
    g.w1_plane = (g.split ? 8 : g.rg1) * g.kb1 * 128;
    g.tile = 4 * g.w1_plane + 4 * g.w2_plane;
    g.ring = g.tile + 4 * g.npass * g.kb1 * 128;
    g.nslot = kSlots;
    if (ct) {
      const int room = (kSmemMax - g.ring - kCtSlots * 8) / g.slot;
      g.nslot = room < kCtSlots ? room : kCtSlots;
    }
    g.bars = g.ring + g.nslot * g.slot;
    g.smem = g.bars + g.nslot * 8;
    if ((g.smem <= kSmemMax && (!ct || g.nslot > g.npass)) || g.nwg < 2)
      break;
  }
  return g;
}

// the splits the kernel takes (checked by the host before a launch; the
// port's ops/megakernel.tc_fits is the same test, for every loader)
inline bool fits(const Geom& g) {
  return g.n1 >= 2 && g.n1 <= 64 * kMaxWg && g.n2 <= 128 &&
         g.n2_out <= 64 && g.smem <= kSmemMax &&
         (!g.ct || g.nslot > g.npass);
}

// ---------------------------------------------------------------- PTX ----

using bulk::fence_async_smem;
using bulk::mbar_expect_tx;
using bulk::mbar_init;
using bulk::mbar_wait;
using bulk::named_sync;
using bulk::saddr;

// wgmma shared-memory descriptor, no swizzle (core matrices of 8 rows x
// 16 bytes, rows contiguous): lbo = bytes between core matrices along K,
// sbo = bytes between 8-row groups along M / N
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// ties registers to the point of the call, so that no read or write of
// an accumulator moves across a wgmma issue or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B (+ d when kAcc), A and B from shared memory: m64n32k16, bf16
// in, f32 out
template <int kAcc>
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "n"(kAcc));
}

// d = A B (+ d when kAcc), A from registers (4 x bf16 pairs), B from
// shared memory: m64n64k16
template <int kAcc>
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kAcc));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// v = hi + lo as the TPU kernel splits it; packed (hi, lo) of a pair
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(v1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16_rn(__fsub_rn(v0, __bfloat162float(h0))),
            __float2bfloat16_rn(__fsub_rn(v1, __bfloat162float(h1))));
}

constexpr uint32_t kNeg = 0x80008000u;   // sign bits of a bf16 pair

// conv_u8 (front.cuh) on the FP32 pipe: (2^23 + u) - (2^23 + 128) is u -
// 128 exactly, times 2^-7 exactly; 0 for u == 0
__device__ __forceinline__ float volt_u8(uint8_t u) {
  const float x = __fmul_rn(
      __fsub_rn(__uint_as_float(0x4B000000u | u), 8388736.0f), 0.0078125f);
  return u ? x : 0.0f;
}

// ---------------------------------------------------------------- jobs ---

// The frames a launch transforms, read through the loader Ld: NaturalU8
// (the raw second) or CtMajor<T> (the Cooley-Tukey-major tiles of
// ops/megakernel.pallas_pretranspose, T uint8_t or __nv_bfloat16; frame
// sample (m1, m2) at tile row m2, lane m1).  Job i < npol * nblk is frame
// (p, j) = (i / nblk, i % nblk) of the second, unmasked, written to `power`
// row i (pol-major: the chain's (npol, nblk, nchan) plane) or, with ffts
// > 0, row (s * npol + p) * ffts + t for j = s * ffts + t (stage A's
// (nseg, npol * ffts, nchan)).  With a list, job npol * nblk + b * npol +
// p is frame (p, list[b]) masked by that block's keep flags (window w of
// the frame zero where keep[w] == 0), written to `power_kur` at the
// frame's pol-major row: the kurtosis stream of the blocks the front
// flagged in part.
template <class Ld>
struct Jobs {
  Ld ld;
  int npol;
  long long nblk;
  int ffts;
  const int* nlist;   // number of listed blocks (device), or nullptr
  const int* list;    // the listed blocks (device)
  const uint8_t* keep;
  int wpf, nkurto;
  float* power;
  float* power_kur;
};

struct Job {
  long long src;          // offset of the frame's first element in the input
  const uint8_t* keep;    // its keep flags, nullptr when unmasked
  float* out;             // its power row
};

// the offset of frame (p, j)'s first element: in the raw second, or of
// its tile
__device__ __forceinline__ long long frame_src(const NaturalU8& ld,
                                               long long p, long long j) {
  return p * ld.nsamp + j * (long long)ld.nfft;
}
template <class T>
__device__ __forceinline__ long long frame_src(const CtMajor<T>& ld,
                                               long long p, long long j) {
  return ld.tile(p, j);
}

template <class Ld>
__device__ __forceinline__ Job job_of(const Jobs<Ld>& J, long long i,
                                      int nchan) {
  const long long nplain = (long long)J.npol * J.nblk;
  Job o;
  long long p, j;
  if (i < nplain) {
    p = i / J.nblk;
    j = i - p * J.nblk;
    long long row = i;
    if (J.ffts > 0) {
      const long long s = j / J.ffts, t = j - s * J.ffts;
      row = (s * J.npol + p) * J.ffts + t;
    }
    o.keep = nullptr;
    o.out = J.power + row * nchan;
  } else {
    const long long q = i - nplain, b = q / J.npol;
    p = q - b * J.npol;
    j = J.list[b];
    o.keep = J.keep + j * J.wpf;
    o.out = J.power_kur + (p * J.nblk + j) * nchan;
  }
  o.src = frame_src(J.ld, p, j);
  return o;
}

// [lo, hi): the bytes of the frame at `src` that one bulk copy brings, the
// 16-byte-aligned span around it clamped to the buffer (hi == lo: none)
__device__ __forceinline__ void span(const Jobs<NaturalU8>& J, long long src,
                                     long long& lo, long long& hi) {
  const unsigned long long base = (unsigned long long)J.ld.raw;
  const unsigned long long end =
      (base + (unsigned long long)J.npol * J.ld.nsamp) & ~15ull;
  const unsigned long long a = base + src;
  unsigned long long l = a & ~15ull;
  if (l < base) l += 16;
  unsigned long long h = (a + J.ld.nfft + 15) & ~15ull;
  if (h > end) h = end;
  lo = (long long)(l - base);
  hi = h > l ? (long long)(h - base) : lo;
}

// the element type a loader reads: bytes of the raw second, or the tiles'
template <class Ld>
struct ElemOf {
  using type = uint8_t;
};
template <class T>
struct ElemOf<CtMajor<T>> {
  using type = T;
};

// ---------------------------------------------------------------- kernel -

template <class Ld>
__global__ void __launch_bounds__(kThreads, 1)
    dft_tc_kernel(Geom G, Jobs<Ld> J, const uint4* __restrict__ w1,
                  const float4* __restrict__ tw,
                  const uint4* __restrict__ w2) {
  constexpr bool kCt = !std::is_same<Ld, NaturalU8>::value;
  using Elem = typename ElemOf<Ld>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = (uint64_t*)(smem + G.bars);
  unsigned char* ring = smem + G.ring;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // this block's frames (jobs j0, j0 + jstep, ...) and its first row k1
  const long long j0 = G.split ? blockIdx.x >> 1 : blockIdx.x;
  const long long jstep = G.split ? gridDim.x >> 1 : gridDim.x;
  const int half = G.split ? blockIdx.x & 1 : 0;
  {
    // the W1 row groups this block holds (split: its half's 8, zero past
    // rg1), then the W2 planes
    const int per_plane = G.w1_plane / 16, per_group = G.kb1 * 8;
    for (int i = tid; i < G.tile / 16; i += nthr) {
      uint4 v;
      if (i < 4 * per_plane) {
        const int q = i / per_plane, r = i - q * per_plane;
        const int grp = 8 * half + r / per_group;
        v = grp < G.rg1 ? w1[((long long)q * G.rg1 + grp) * per_group +
                             r % per_group]
                        : make_uint4(0, 0, 0, 0);
      } else {
        v = w2[i - 4 * per_plane];
      }
      ((uint4*)smem)[i] = v;
    }
  }
  fence_async_smem();
  if (tid == 0) {
    for (int s = 0; s < (kCt ? G.nslot : kSlots); ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long njobs = (long long)J.npol * J.nblk +
                          (J.nlist ? (long long)J.npol * *J.nlist : 0);
  // thread 0 brings the raw frame of local job k into slot k % kSlots
  // (kSlots jobs ahead; a slot is refilled once every thread has passed
  // the barrier after converting it)
  auto fetch = [&](int k) {
    if constexpr (!kCt) {
      const long long i = j0 + k * jstep;
      if (i >= njobs) return;
      long long lo, hi;
      span(J, job_of(J, i, G.nchan).src, lo, hi);
      const int s = k % kSlots;
      fence_async_smem();
      mbar_expect_tx(&full[s], (uint32_t)(hi - lo));
      if (hi > lo)
        bulk::load(ring + s * G.slot, J.ld.raw + lo, (uint32_t)(hi - lo),
                  &full[s]);
    }
  };
  // CT-major tiles: unit q = k npass + h is slice h (tile rows [32h, 32h +
  // 32) within n2, one contiguous run) of local job k, brought into slot q
  // % nslot, nslot - npass >= 1 passes ahead of the consumers
  auto fetch_ct = [&](int q) {
    if constexpr (kCt) {
      const int k = q / G.npass, h = q - k * G.npass;
      const long long i = j0 + k * jstep;
      if (i >= njobs) return;
      const int rows = G.n2 - 32 * h < 32 ? G.n2 - 32 * h : 32;
      const uint32_t bytes = rows * 128 * (uint32_t)sizeof(Elem);
      const int s = q % G.nslot;
      fence_async_smem();
      mbar_expect_tx(&full[s], bytes);
      bulk::load(ring + s * G.slot,
                J.ld.x + job_of(J, i, G.nchan).src + 32 * h * 128, bytes,
                &full[s]);
    }
  };
  if constexpr (kCt) {
    if (tid == 0)
      for (int q = 0; q < G.nslot; ++q) fetch_ct(q);
  } else {
    if (tid == 0)
      for (int k = 0; k < kSlots; ++k) fetch(k);
  }

  const int wg = tid >> 7, wl = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = 64 * (G.split ? half : wg);   // this warpgroup's rows
  const uint32_t s_w1 = saddr(smem), s_w2 = s_w1 + 4 * G.w1_plane;
  const uint32_t s_tile = s_w1 + G.tile;
  const uint32_t sbo1 = G.kb1 * 128, sbo2 = G.kb2 * 128;
  const uint32_t a_base = s_w1 + (G.split ? 0 : wg * 8 * sbo1);
  const long long twplane = (long long)4 * G.nwg * 4 * G.npass * 32;
  const int nks = G.kb1 / 2;

  // slice h (m2 rows [32h, 32h + 32)) of a job's frame from its slot into
  // the bf16 tile, core-matrix order; padding cells become 0.  An item is
  // one core-matrix row: m2 (neighbouring lanes, neighbouring bytes) x 8
  // m1 of core block c, one 16-byte store.  The common case, a full core
  // block held by the slot, takes 8 shared-memory byte loads and no
  // per-sample test (a masked frame steps its window index instead of
  // dividing); the edges (padding, a frame at an unaligned end of the
  // buffer, whose bytes outside the slot's span come from device memory)
  // take the sample-by-sample path.
  auto convert = [&](const Job& jb, int slot, long long lo, long long hi,
                     int h) {
    if constexpr (!kCt) {
      const unsigned char* sl = ring + slot * G.slot;
      const bool whole = jb.src >= lo && jb.src + G.nfft <= hi;
      const uint32_t fr = saddr(sl) + (uint32_t)(whole ? jb.src - lo : 0);
      for (int it = tid; it < 32 * G.kb1; it += nthr) {
        const int m2 = 32 * h + (it & 31), c = it >> 5;
        const int n0 = 8 * c * G.n2 + m2;
        float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (m2 < G.n2 && whole && 8 * c + 8 <= G.n1) {
          uint32_t b[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            asm volatile("ld.shared.u8 %0, [%1];"
                         : "=r"(b[e])
                         : "r"(fr + n0 + e * G.n2));
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = volt_u8((uint8_t)b[e]);
          if (jb.keep) {
            int w = n0 / J.nkurto, r = n0 - w * J.nkurto;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (!__ldg(jb.keep + w)) v[e] = 0.0f;
              for (r += G.n2; r >= J.nkurto; r -= J.nkurto) ++w;
            }
          }
        } else if (m2 < G.n2) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int n = n0 + e * G.n2;
            if (8 * c + e < G.n1) {
              const long long o = jb.src + n;
              v[e] = volt_u8((o >= lo && o < hi) ? sl[o - lo]
                                                 : __ldg(J.ld.raw + o));
              if (jb.keep && !__ldg(jb.keep + n / J.nkurto)) v[e] = 0.0f;
            }
          }
        }
        // both voltages of a pair are exact in bf16: their top halves
        uint32_t word[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2)
          word[e >> 1] = __byte_perm(__float_as_uint(v[e]),
                                     __float_as_uint(v[e + 1]), 0x7632);
        *(uint4*)(smem + G.tile + (m2 >> 3) * sbo1 + c * 128 +
                  (m2 & 7) * 16) = make_uint4(word[0], word[1], word[2],
                                              word[3]);
      }
    }
  };
  // CT-major tiles: slice h of a job's frame, unit q, waited for in its
  // slot and converted as `convert` does, into the same values at the
  // same places.  A core-matrix row (8 m1 at one m2) is 8 elements of tile
  // row m2, contiguous: one 8-byte (u8) or 16-byte (bf16) load.  bf16
  // tiles hold the voltages already (exact: the words are the tile's
  // top halves); lanes m1 >= n1 and masked windows become 0 by clearing
  // their halves.
  auto convert_ct = [&](const Job& jb, int q, int h) {
    if constexpr (kCt) {
      const int slot = q % G.nslot;
      mbar_wait(&full[slot], (uint32_t)(q / G.nslot) & 1);
      const uint32_t sl = saddr(ring + slot * G.slot);
      for (int it = tid; it < 32 * G.kb1; it += nthr) {
        const int r = it & 31, m2 = 32 * h + r, c = it >> 5;
        const int nv = G.n1 - 8 * c;      // lanes of the core block in n1
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        if (m2 < G.n2 && nv > 0) {
          const uint32_t a =
              sl + (uint32_t)((r * 128 + 8 * c) * sizeof(Elem));
          if constexpr (sizeof(Elem) == 1) {
            uint32_t b[2];
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                         : "=r"(b[0]), "=r"(b[1])
                         : "r"(a));
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const uint32_t x = b[w >> 1] >> (16 * (w & 1));
              const float v0 = volt_u8((uint8_t)x);
              const float v1 = volt_u8((uint8_t)(x >> 8));
              word[w] = __byte_perm(__float_as_uint(v0), __float_as_uint(v1),
                                    0x7632);
            }
          } else {
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                         : "=r"(word[0]), "=r"(word[1]), "=r"(word[2]),
                           "=r"(word[3])
                         : "r"(a));
          }
          uint32_t kept = nv < 8 ? (1u << nv) - 1 : 0xFFu;
          if (jb.keep) {
            const int n0 = 8 * c * G.n2 + m2;
            int w = n0 / J.nkurto, rr = n0 - w * J.nkurto;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (e < nv && !__ldg(jb.keep + w)) kept &= ~(1u << e);
              for (rr += G.n2; rr >= J.nkurto; rr -= J.nkurto) ++w;
            }
          }
          if (kept != 0xFFu) {
#pragma unroll
            for (int w = 0; w < 4; ++w)
              word[w] &= ((kept >> (2 * w)) & 1 ? 0x0000FFFFu : 0u) |
                         ((kept >> (2 * w + 1)) & 1 ? 0xFFFF0000u : 0u);
          }
        }
        *(uint4*)(smem + G.tile + (m2 >> 3) * sbo1 + c * 128 +
                  (m2 & 7) * 16) = make_uint4(word[0], word[1], word[2],
                                              word[3]);
      }
    }
  };

  long long i = j0;
  if (i >= njobs) return;
  Job cur = job_of(J, i, G.nchan);
  if constexpr (kCt) {
    for (int h = 0; h < G.npass; ++h) convert_ct(cur, h, h);
    fence_async_smem();
  } else {
    long long lo, hi;
    span(J, cur.src, lo, hi);
    mbar_wait(&full[0], 0);
    for (int h = 0; h < G.npass; ++h) convert(cur, 0, lo, hi, h);
    fence_async_smem();
  }
  for (int k = 0; i < njobs; i += jstep, ++k) {
    const bool more = i + jstep < njobs;
    const int nslot = (k + 1) % kSlots;
    Job nxt = cur;
    long long nlo = 0, nhi = 0;
    if (more) {
      nxt = job_of(J, i + jstep, G.nchan);
      if constexpr (!kCt) {
        span(J, nxt.src, nlo, nhi);
        mbar_wait(&full[nslot], (uint32_t)((k + 1) / kSlots) & 1);
      }
    }
    float pr[32], pi[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) pr[e] = pi[e] = 0.0f;

    for (int h = 0; h < G.npass; ++h) {
      named_sync(1, nthr);    // slice h holds this frame
      // job k was converted before this barrier: its slot takes job k + 3
      // (CT: unit k npass + h's slot takes the unit nslot later)
      if constexpr (kCt) {
        if (tid == 0) fetch_ct(k * G.npass + h + G.nslot);
      } else {
        if (h == 0 && tid == 0) fetch(k + kSlots);
      }
      // ---- stage 1, pass h: the four W1 planes against m2 [32h, 32h+32),
      // every k16 product from zero, added rounded to nearest
      float acc[4][16], c0[16], c1[16], c2[16], c3[16];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[q][e] = 0.0f;
      const uint32_t b_base = s_tile + 4 * h * sbo1;
      for (int ks = 0; ks < nks; ++ks) {
        const uint32_t a0 = a_base + ks * 256;
        const uint64_t b = desc(b_base + ks * 256, 128, sbo1);
        wg_fence();
        wgmma_n32_ss<0>(c0, desc(a0, 128, sbo1), b);
        wgmma_n32_ss<0>(c1, desc(a0 + G.w1_plane, 128, sbo1), b);
        wgmma_n32_ss<0>(c2, desc(a0 + 2 * G.w1_plane, 128, sbo1), b);
        wgmma_n32_ss<0>(c3, desc(a0 + 3 * G.w1_plane, 128, sbo1), b);
        wg_commit();
        wg_wait<0>();
        reg_fence(c0);
        reg_fence(c1);
        reg_fence(c2);
        reg_fence(c3);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          acc[0][e] = __fadd_rn(acc[0][e], c0[e]);
          acc[1][e] = __fadd_rn(acc[1][e], c1[e]);
          acc[2][e] = __fadd_rn(acc[2][e], c2[e]);
          acc[3][e] = __fadd_rn(acc[3][e], c3[e]);
        }
      }
      named_sync(2, nthr);    // every thread is done reading slice h

      // ---- twiddle and split: the A fragments of stage-2 k-steps 2h,
      // 2h + 1 (accumulator n8 chunk j = 2e + cj -> A regs 2cj, 2cj + 1)
      uint32_t rh[2][4], rl[2][4], ih[2][4], il[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long ti =
            ((long long)(row0 / 16 + wl) * 4 * G.npass + 4 * h + j) * 32 +
            lane;
        const float4 twr = __ldg(tw + ti), twi = __ldg(tw + ti + twplane);
        const float tr[4] = {twr.x, twr.y, twr.z, twr.w};
        const float tim[4] = {twi.x, twi.y, twi.z, twi.w};
        float br[4], bi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ar = __fadd_rn(acc[0][4 * j + r], acc[1][4 * j + r]);
          const float ai = __fadd_rn(acc[2][4 * j + r], acc[3][4 * j + r]);
          br[r] = __fsub_rn(__fmul_rn(ar, tr[r]), __fmul_rn(ai, tim[r]));
          bi[r] = __fadd_rn(__fmul_rn(ar, tim[r]), __fmul_rn(ai, tr[r]));
        }
        const int e = j >> 1, cj = j & 1;
        split2(br[0], br[1], rh[e][2 * cj], rl[e][2 * cj]);
        split2(br[2], br[3], rh[e][2 * cj + 1], rl[e][2 * cj + 1]);
        split2(bi[0], bi[1], ih[e][2 * cj], il[e][2 * cj]);
        split2(bi[2], bi[3], ih[e][2 * cj + 1], il[e][2 * cj + 1]);
      }

      // ---- stage 2, k-steps 2h and 2h + 1: pr's six terms and pi's in
      // two groups, pr added while pi's run; the next frame's slice h is
      // converted while the first k-step's products run
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t kb = s_w2 + (2 * h + e) * 256;
        const uint64_t wrh = desc(kb, 128, sbo2);
        const uint64_t wrl = desc(kb + G.w2_plane, 128, sbo2);
        const uint64_t wih = desc(kb + 2 * G.w2_plane, 128, sbo2);
        const uint64_t wil = desc(kb + 3 * G.w2_plane, 128, sbo2);
        const uint32_t nih[4] = {ih[e][0] ^ kNeg, ih[e][1] ^ kNeg,
                                 ih[e][2] ^ kNeg, ih[e][3] ^ kNeg};
        const uint32_t nil[4] = {il[e][0] ^ kNeg, il[e][1] ^ kNeg,
                                 il[e][2] ^ kNeg, il[e][3] ^ kNeg};
        float cr[32], ci[32];
        wg_fence();
        // pr = sum w2r br - w2i bi; pi = sum w2i br + w2r bi
        wgmma_n64_rs<0>(cr, rl[e], wrh);
        wgmma_n64_rs<1>(cr, rh[e], wrl);
        wgmma_n64_rs<1>(cr, nil, wih);
        wgmma_n64_rs<1>(cr, nih, wil);
        wgmma_n64_rs<1>(cr, rh[e], wrh);
        wgmma_n64_rs<1>(cr, nih, wih);
        wg_commit();
        wgmma_n64_rs<0>(ci, rl[e], wih);
        wgmma_n64_rs<1>(ci, rh[e], wil);
        wgmma_n64_rs<1>(ci, il[e], wrh);
        wgmma_n64_rs<1>(ci, ih[e], wrl);
        wgmma_n64_rs<1>(ci, rh[e], wih);
        wgmma_n64_rs<1>(ci, ih[e], wrh);
        wg_commit();
        if (e == 0 && more) {
          if constexpr (kCt)
            convert_ct(nxt, (k + 1) * G.npass + h, h);
          else
            convert(nxt, nslot, nlo, nhi, h);
        }
        wg_wait<1>();
        reg_fence(cr);
#pragma unroll
        for (int q = 0; q < 32; ++q) pr[q] = __fadd_rn(pr[q], cr[q]);
        wg_wait<0>();
        reg_fence(ci);
#pragma unroll
        for (int q = 0; q < 32; ++q) pi[q] = __fadd_rn(pi[q], ci[q]);
      }
      if (more) fence_async_smem();
    }

    // ---- detect, linear channels ----
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k1 = row0 + wl * 16 + g + 8 * (r >> 1);
        const int k2 = 8 * j + 2 * t4 + (r & 1);
        const int kk = k1 + G.n1 * k2;
        const float a = pr[4 * j + r], b = pi[4 * j + r];
        if (k1 < G.n1 && k2 < G.n2_out && kk < G.nchan)
          cur.out[kk] = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
      }
    }
    cur = nxt;
  }
}

// Launch over `max_jobs` jobs at most (the grid: one block per SM, fewer
// for fewer jobs; split, an even number, two per job); the kernel reads
// the listed count itself.
template <class Ld>
inline cudaError_t launch(const Geom& G, const Jobs<Ld>& J,
                          long long max_jobs, const void* w1, const void* tw,
                          const void* w2, cudaStream_t st) {
  const int ct = std::is_same<Ld, NaturalU8>::value
                     ? 0
                     : (int)sizeof(typename ElemOf<Ld>::type);
  if (!fits(G) || G.ct != ct) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dft_tc_kernel<Ld>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G.smem);
  if (e != cudaSuccess) return e;
  int dev = 0, nsm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const long long want = G.split ? 2 * max_jobs : max_jobs;
  int grid = (int)(want < nsm ? want : nsm);
  if (G.split) grid -= grid % 2;
  if (grid < 1) return cudaSuccess;
  dft_tc_kernel<Ld><<<grid, G.split ? 128 : 128 * G.nwg, G.smem, st>>>(
      G, J, (const uint4*)w1, (const float4*)tw, (const uint4*)w2);
  return cudaGetLastError();
}

}  // namespace dft_tc
