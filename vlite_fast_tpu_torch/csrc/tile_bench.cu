// The tile-transpose microbenchmark, hand-written for Hopper (sm_90a).
// Called through ctypes from benchmarks/transpose_prims.py:tile_sum; the
// launch (grid, cluster, shared memory) is planned here, from the
// layout's constants.
//
// Replaces the TPU kernel benchmarks/bench_transpose_prims_tpu.py:
// tile_bench (body _tile_kernel): each of `reps` grid steps sums the nb
// (128, 128) f32 tiles of a (nb * 128, 128) input, each tile
//   'none' (0)  as it is,
//   'xlu'  (1)  transposed,
//   'mxu'  (2)  transposed by a bf16 identity product with f32
//               accumulation (the tile rounded to bf16, transposed),
// and writes the (128, 128) sum; every step writes the same result.
// Every step is one block that computes its own whole sum from zero,
// reading every tile; no step shares a sum or keeps a tile in registers
// across steps, and every tile is transposed ('xlu': read down its
// columns) or multiplied ('mxu') in every step.  Each tile's value is
// added to the running sum with __fadd_rn in tile order, so every mode
// equals its plain version bit for bit.
//
// What bounds it: the adds (reps x nb x 128^2, 0.010 ms at the f32 peak
// for the script's 320 x 128 tiles) or, for 'mxu', the identity products
// the mode prescribes (reps x nb x 2 x 128^3, 0.174 ms at the bf16 peak).
// Every step reads the 8.4 MB input; read from L2 by every block, that was
// 2.7 GB through L2 per call.  Design (bulk.cuh):
//   - clusters of 8 blocks (consecutive steps; the last cluster's blocks
//     past `reps` only take part in its barriers).  The input streams
//     through a ring of stages of 64 tile rows (32 KB, 3 of them; 'mxu'
//     32 rows, 5); stage k is loaded by the cluster's active block
//     k % nact, with one multicast bulk copy into the same stage of every
//     active block (.multicast::cluster), so L2 serves each stage once
//     per cluster;
//   - a producer warp a block: lane 0 loads this block's stages as soon
//     as their slots are free everywhere (its empty barriers: one
//     arrival from each active block); lane 1 forwards: once this
//     block's 8 consumer warps have read a stage (its used barrier, local
//     arrivals) it sets this block's full barrier to expect the slot's
//     next stage (expect_tx) and sends one remote arrival (mapa) to the
//     block that loads it.  The consumers only wait on full barriers and
//     arrive on local ones: the cluster-scope traffic stays off their
//     path;
//   - 'none': thread i reads float4s i, i + 256, ... of the stage (a warp
//     reads whole 512-byte rows: no bank conflict) and adds them to its
//     64 sums; staged row r, columns 4 i' .. 4 i' + 3 of stage j of a
//     tile are output row 64 j + r;
//   - 'xlu': the thread of output row R (lane + 32 m) and columns
//     64 j + 4 c .. + 3 reads staged rows 4 c .. 4 c + 3 at column R, four
//     words down the stage's column R (the lanes of a warp read 32
//     neighbouring words of a row: no bank conflict), and adds each at
//     its transposed place;
//   - 'mxu': warp w converts the stage's 8 tile rows 8 (w & 3) .. (its
//     output columns) to bf16 in a buffer of its own (row stride 136),
//     then for each of its four 16-row blocks of output rows
//     64 (w >> 2) .. runs mma.sync m16n8k16: D = I x B with B the bf16
//     tile rows fed by ldmatrix (a tile row is B's column: B[k][n] =
//     tile[n][k]), all 8 k-steps chained from zero (one product of each
//     output is the tile's value, the others are zeros, so the sum is
//     exact).  Its 64 sums, 16 products and B fragments need more than
//     the 96 registers that keep two blocks of 9 warps an SM: ptxas
//     spills a few words to the stack.  A cap of 104 or 112 registers
//     spills nothing but leaves one block an SM, and runs slower;
//   - the sum leaves through shared memory in whole rows;
//   - a cluster-wide barrier after the mbarriers' init and before any
//     block exits (peers may still multicast or arrive until then).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;                    // the consumers
constexpr int kWarps = kThreads / 32;            // + one producer warp
constexpr int kCluster = 8;                      // steps a cluster
constexpr int kBfStride = 136;                   // bf16 a converted row
constexpr int kBfBytes = 8 * kBfStride * 2;      // a warp's 8 rows

// A block's shared memory by mode: the ring's stages (64 tile rows, 32 KB,
// 3 of them for 'none' / 'xlu'; 32 rows, 16 KB, 5 for 'mxu', a warp's 4
// column blocks), 'mxu''s bf16 buffer a consumer warp, then the full,
// empty and used mbarriers of each stage; two blocks an SM either way
template <int kImpl>
struct Layout {
  static constexpr int kRows = kImpl == 2 ? 32 : 64;     // tile rows a stage
  static constexpr int kStages = kImpl == 2 ? 5 : 3;
  static constexpr int kStageBytes = kRows * kLane * 4;
  static constexpr int kBf = kImpl == 2 ? kWarps * kBfBytes : 0;
  static constexpr int kSmem = kStages * kStageBytes + kBf + 3 * kStages * 8;
  // the sum leaves through the stages: 128 rows of 129 floats
  static_assert(kStages * kStageBytes >= kLane * (kLane + 1) * 4, "ring");
  static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(bulk::saddr(row))
      : "memory");
}

template <int kImpl>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads + 32, 2)
    tile_kernel(const float* __restrict__ x, int nb, int reps,
                float* __restrict__ out) {
  using L = Layout<kImpl>;
  constexpr int kR = L::kRows, kNs = L::kStages, kSB = L::kStageBytes;
  constexpr int kQ = kLane / kR;                          // stages a tile
  constexpr int kPer = kR * kLane / 4 / kThreads;         // float4s a stage
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* bf = smem + kNs * kSB;
  uint64_t* full = (uint64_t*)(bf + L::kBf);
  uint64_t* empty = full + kNs;
  uint64_t* used = empty + kNs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)bulk::cluster_rank();
  int ncl;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(ncl));
  const int nact = min(ncl, reps - ((int)blockIdx.x - rank));
  const int nstage = nb * kQ;
  if (tid == 0) {
    for (int q = 0; q < kNs; ++q) {
      bulk::mbar_init(&full[q], 1);
      bulk::mbar_init(&empty[q], nact);
      bulk::mbar_init(&used[q], kWarps);
    }
    bulk::fence_mbar_init();
  }
  bulk::cluster_sync();
  if (rank < nact && warp == kWarps && lane == 0) {
    // the loader: stages rank, rank + nact, ..., each once every active
    // block has released the slot's previous stage (the releases of the
    // slots this block refills arrive here, in order: bit q of `par` is
    // the parity of the next phase of empty[q])
    const uint16_t mask = (uint16_t)((1u << nact) - 1u);
    uint32_t par = 0;
    for (int k = rank; k < nstage; k += nact) {
      const int q = k % kNs;
      if (k >= kNs) {
        bulk::mbar_wait<true>(&empty[q], (par >> q) & 1u);
        par ^= 1u << q;
      }
      bulk::load_multicast(smem + q * kSB, x + (long long)k * kR * kLane, kSB,
                           &full[q], mask);
    }
  } else if (rank < nact && warp == kWarps && lane == 1) {
    // the forwarder: this block's full barrier expects each stage's bytes
    // once the slot's previous stage is read here (used), and the block
    // that loads the slot's next stage hears of it (one remote arrival)
    for (int k = 0; k < kNs && k < nstage; ++k)
      bulk::mbar_expect_tx(&full[k], kSB);
    for (int k = 0; k + kNs < nstage; ++k) {
      const int q = k % kNs;
      bulk::mbar_wait(&used[q], (uint32_t)(k / kNs) & 1u);
      bulk::mbar_expect_tx(&full[q], kSB);
      bulk::mbar_arrive_remote(&empty[q], (k + kNs) % nact);
    }
  } else if (rank < nact && warp < kWarps) {
    float acc[kQ][kPer][4];
#pragma unroll
    for (int j = 0; j < kQ; ++j)
#pragma unroll
      for (int m = 0; m < kPer; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.0f;
    // mxu: identity A fragments (a0 = a3 on the diagonal block), the
    // warp's 8 output columns cb and its four 16-row blocks from 4 rh
    const int g = lane >> 2, t = lane & 3, cb = warp & 3, rh = warp >> 2;
    const uint32_t eye = (g == 2 * t ? 0x3F80u : 0u) |
                         (g == 2 * t + 1 ? 0x3F800000u : 0u);
    for (int b = 0; b < nb; ++b) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int k = b * kQ + j, q = k % kNs;
        bulk::mbar_wait(&full[q], (uint32_t)(k / kNs) & 1u);
        const float4* st = (const float4*)(smem + q * kSB);
        if (kImpl == 0) {
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            const float4 v = st[tid + kThreads * m];
            acc[j][m][0] = __fadd_rn(acc[j][m][0], v.x);
            acc[j][m][1] = __fadd_rn(acc[j][m][1], v.y);
            acc[j][m][2] = __fadd_rn(acc[j][m][2], v.z);
            acc[j][m][3] = __fadd_rn(acc[j][m][3], v.w);
          }
        } else if (kImpl == 1) {
          // output row R = lane + 32 (m & 3), columns kR j + 4 c .. + 3
          // (c = 2 warp + (m >> 2)): staged rows 4 c .. 4 c + 3, column R
          const float* sf = (const float*)st;
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            const float* col =
                sf + 4 * (2 * warp + (m >> 2)) * kLane + lane + 32 * (m & 3);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j][m][e] = __fadd_rn(acc[j][m][e], col[e * kLane]);
          }
        }
        if (kImpl != 2) {
          __syncwarp();
          if (lane == 0) bulk::mbar_arrive(&used[q]);
          continue;
        }
        // the warp converts the stage's 8 tile rows it multiplies (its
        // output columns) into its own buffer: no block-wide barrier
        uint8_t* buf = bf + warp * kBfBytes;
        __syncwarp();   // the last stage's ldmatrix has read the buffer
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 v = st[(8 * cb + r) * (kLane / 4) + lane];
          *(uint2*)(buf + (r * kBfStride + 4 * lane) * 2) =
              make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
        }
        __syncwarp();
        if (lane == 0) bulk::mbar_arrive(&used[q]);
        // B fragments of two k-steps at a time (ldmatrix.x4: k-steps 2 kp
        // and 2 kp + 1, k 0-7 and 8-15 of each), the four 16-row blocks'
        // products chained from zero over the 8 k-steps
        float d[4][4];
#pragma unroll
        for (int rb = 0; rb < 4; ++rb)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[rb][e] = 0.0f;
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          const int mtx = lane >> 3;
          uint32_t r[4];
          ldmatrix_x4(r, buf + ((lane & 7) * kBfStride +
                                16 * (2 * kp + (mtx >> 1)) + 8 * (mtx & 1)) *
                                   2);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int rb = 0; rb < 4; ++rb) {
              const uint32_t a = 2 * kp + h == 4 * rh + rb ? eye : 0u;
              mma_bf16(d[rb], a, 0u, 0u, a, r[2 * h], r[2 * h + 1]);
            }
        }
#pragma unroll
        for (int rb = 0; rb < 4; ++rb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][rb][e] = __fadd_rn(acc[j][rb][e], d[rb][e]);
      }
    }
    // the sum leaves through shared memory (the stages, all read), in
    // whole output rows: out[r][c] at o[r * (kLane + 1) + c]
    float* o = (float*)smem;
    bulk::named_sync(1, kThreads);
#pragma unroll
    for (int j = 0; j < kQ; ++j)
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int i = tid + kThreads * m;
        if (kImpl == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[(kR * j + (i >> 5)) * (kLane + 1) + 4 * (i & 31) + e] =
                acc[j][m][e];
        } else if (kImpl == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[(lane + 32 * (m & 3)) * (kLane + 1) + kR * j +
              4 * (2 * warp + (m >> 2)) + e] = acc[j][m][e];
        } else {
          float* p = o + (16 * (4 * rh + m) + g) * (kLane + 1) + kR * j +
                     8 * cb + 2 * t;
          p[0] = acc[j][m][0];
          p[1] = acc[j][m][1];
          p[8 * (kLane + 1)] = acc[j][m][2];
          p[8 * (kLane + 1) + 1] = acc[j][m][3];
        }
      }
    bulk::named_sync(1, kThreads);
    for (int e = tid; e < kLane * kLane; e += kThreads)
      out[e] = o[(e >> 7) * (kLane + 1) + (e & (kLane - 1))];
  }
  __syncwarp();
  bulk::cluster_sync();   // no block leaves while a peer may still write
}

template <int kImpl>
cudaError_t launch(const float* x, int nb, int reps, float* out,
                   cudaStream_t st) {
  constexpr int smem = Layout<kImpl>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<kImpl>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int grid = (reps + kCluster - 1) / kCluster * kCluster;
  tile_kernel<kImpl><<<grid, kThreads + 32, smem, st>>>(x, nb, reps, out);
  return cudaGetLastError();
}

}  // namespace

// x f32 (nb * 128, 128); impl 0 none, 1 xlu, 2 mxu; reps grid steps
// (whole clusters of 8 blocks, block s step s); out f32 (128, 128).
// Returns a cudaError_t.
extern "C" int vf_tile_bench(const void* x, int nb, int impl, int reps,
                             void* out, void* stream) {
  const float* xi = (const float*)x;
  float* o = (float*)out;
  if (nb < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (impl) {
    case 0: return (int)launch<0>(xi, nb, reps, o, st);
    case 1: return (int)launch<1>(xi, nb, reps, o, st);
    case 2: return (int)launch<2>(xi, nb, reps, o, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
