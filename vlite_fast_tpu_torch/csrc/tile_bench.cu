// The tile-transpose microbenchmark, hand-written for Hopper (sm_90a).
// Called through ctypes from benchmarks/transpose_prims.py:tile_sum.
//
// Replaces the TPU kernel benchmarks/bench_transpose_prims_tpu.py:
// tile_bench (body _tile_kernel): each of `reps` grid steps sums the nb
// (128, 128) f32 tiles of a (nb * 128, 128) input, each tile
//   'none' (0)  as it is,
//   'xlu'  (1)  transposed,
//   'mxu'  (2)  transposed by a bf16 identity product with f32
//               accumulation (the tile rounded to bf16, transposed),
// and writes the (128, 128) sum; every step writes the same result.
//
//   tile_kernel  one block per grid step, 256 threads, over the nb tiles
//                in order:
//     none  each thread sums 64 outputs straight from device memory;
//     xlu   the tile is staged in shared memory at row stride 129, and
//           each thread reads its outputs down a column (the 32 lanes of a
//           warp take neighbouring columns: 32 banks);
//     mxu   the tile is staged at row stride 132, and each warp runs
//           mma.sync m16n8k16 (bf16 in, f32 accumulate) for its 16 rows of
//           the transposed tile against the identity: A[i][k] = tile[k][i]
//           (the fragments' 32 lanes hit 32 banks), B = I, the 8 k-steps
//           chained from zero (one product of each output is the tile's
//           value, the others are zeros, so the sum is exact).
//   Each tile's value is added to the running sum with __fadd_rn in tile
//   order, so every mode equals its plain version bit for bit.
//
// What bounds it: the adds of the sum (reps x nb x 128^2, 0.010 ms at the
// f32 peak for the script's 320 x 128 tiles) and, as written, the reads:
// every step reads the 8.4 MB input, from L2 after the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kPer = kLane * kLane / kThreads;   // outputs per thread

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// one bf16 of the identity: 1.0 where row k meets column n
__device__ __forceinline__ uint32_t eye2(int k, int n) {
  return (k == n ? 0x3F80u : 0u) | (k + 1 == n ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kImpl>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const float* __restrict__ x, int nb, float* __restrict__ out) {
  constexpr int kStride = kImpl == 2 ? 132 : 129;
  extern __shared__ float tile[];                  // (128, kStride)
  const int tid = threadIdx.x;
  if (kImpl != 2) {
    // thread: column c, rows r0 + 2q
    const int c = tid & (kLane - 1), r0 = tid >> 7;
    float acc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[q] = 0.0f;
    for (int b = 0; b < nb; ++b) {
      const float* xb = x + (long long)b * kLane * kLane;
      if (kImpl == 0) {
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          acc[q] = __fadd_rn(acc[q], __ldg(xb + (r0 + 2 * q) * kLane + c));
      } else {
        __syncthreads();   // the last tile was read
        for (int e = tid; e < kLane * kLane; e += kThreads)
          tile[(e >> 7) * kStride + (e & (kLane - 1))] = __ldg(xb + e);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          acc[q] = __fadd_rn(acc[q], tile[c * kStride + r0 + 2 * q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) out[(r0 + 2 * q) * kLane + c] = acc[q];
    return;
  }
  // mxu: warp w computes rows i0 = 16 w of the transposed tile, all 16
  // column tiles of 8
  const int lane = tid & 31, i0 = (tid >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int b = 0; b < nb; ++b) {
    const float* xb = x + (long long)b * kLane * kLane;
    __syncthreads();
    for (int e = tid; e < kLane * kLane; e += kThreads)
      tile[(e >> 7) * kStride + (e & (kLane - 1))] = __ldg(xb + e);
    __syncthreads();
    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* col = tile + (kk * 16 + 2 * t) * kStride + i0 + g;
      a[kk][0] = pack_bf16(col[0], col[kStride]);
      a[kk][1] = pack_bf16(col[8], col[kStride + 8]);
      a[kk][2] = pack_bf16(col[8 * kStride], col[9 * kStride]);
      a[kk][3] = pack_bf16(col[8 * kStride + 8], col[9 * kStride + 8]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = kk * 16 + 2 * t, n = j * 8 + g;
        mma_bf16(d, a[kk], eye2(k, n), eye2(k + 8, n));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], d[e]);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float* o = out + (i0 + g) * kLane + j * 8 + 2 * t;
    o[0] = acc[j][0];
    o[1] = acc[j][1];
    o[8 * kLane] = acc[j][2];
    o[8 * kLane + 1] = acc[j][3];
  }
}

template <int kImpl>
cudaError_t launch(const float* x, int nb, int reps, float* out,
                   cudaStream_t st) {
  const int smem = kImpl == 0 ? 0 : kLane * (kImpl == 2 ? 132 : 129) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<kImpl>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  tile_kernel<kImpl><<<reps, kThreads, smem, st>>>(x, nb, out);
  return cudaGetLastError();
}

}  // namespace

// x f32 (nb * 128, 128); impl 0 none, 1 xlu, 2 mxu; reps grid steps; out
// f32 (128, 128).  Returns a cudaError_t.
extern "C" int vf_tile_bench(const void* x, int nb, int impl, int reps,
                             void* out, void* stream) {
  const float* xi = (const float*)x;
  float* o = (float*)out;
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
