// Two-stage subband dedispersion, hand-written for Hopper (sm_90a).
// Called through ctypes from ops/dedisperse_pallas.py:dedisperse_pallas.
//
// Replaces the TPU kernel vlite_fast_tpu/ops/dedisperse_pallas.py:
// dedisperse_pallas (bodies _stage1_fold_kernel and _stage2_fold_kernel).
// Same function as the port's ops/dedisperse.dedisperse:
//
//   stage 1: y[b, s, t] = sum_{ch in s} fbT[ch, min(t + rel[b, ch], ntime-1)]
//            for t < t1_len = ntime_out + max_sub_delay
//   stage 2: out[dm, t] = sum_s y[batch_of_dm[dm], s, t + sub_delays[dm, s]]
//
// on a channel-major copy of the zapped filterbank (fbT, (nchan, ntime)),
// so that neighbouring threads (neighbouring t) read neighbouring samples.
// One thread per output sample, a loop over the subband's channels in
// stage 1 and over the subbands in stage 2; each block loads its own row
// of delays into shared memory.
//
// What bounds it: reads.  At the production gulp (4096 channels,
// ~26.7k samples, 128 batches, 4864 trials) stage 1 makes 128 x 4096 x
// ~26.6k reads of fbT (0.44 GB, larger than the 50 MB L2) and stage 2
// 4864 x 128 x 15360 reads of y (1.75 GB).  The design orders the grid
// so that blocks running together share their inputs in L2: stage 1 puts
// the batch index fastest, so the 128 batches of one (subband, time tile)
// reuse the same fbT rows; stage 2 walks the trials in order, so the ~38
// trials of one batch reuse that batch's y rows.  Tiling time in shared
// memory and register-blocking several trials per thread is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void stage1_kernel(const float* __restrict__ fbT, int ntime,
                              int nchan, int w, const int* __restrict__ rel,
                              int t1_len, int nsub, float* __restrict__ y) {
  extern __shared__ int rs[];   // (w,) in-subband delays of (b, s)
  const int b = blockIdx.x, s = blockIdx.z;
  for (int i = threadIdx.x; i < w; i += blockDim.x)
    rs[i] = rel[(long long)b * nchan + s * w + i];
  __syncthreads();
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= t1_len) return;
  const float* row = fbT + (long long)s * w * ntime;
  float acc = 0.0f;
  for (int ch = 0; ch < w; ++ch) {
    const int idx = min(max(t + rs[ch], 0), ntime - 1);
    acc += __ldg(&row[(long long)ch * ntime + idx]);
  }
  y[((long long)b * nsub + s) * t1_len + t] = acc;
}

__global__ void stage2_kernel(const float* __restrict__ y, int nsub,
                              int t1_len, const int* __restrict__ sub_delays,
                              const int* __restrict__ batch_of_dm,
                              int ntime_out, float* __restrict__ out) {
  extern __shared__ int sd[];   // (nsub,) subband delays of this trial
  const int dm = blockIdx.y;
  for (int i = threadIdx.x; i < nsub; i += blockDim.x)
    sd[i] = sub_delays[(long long)dm * nsub + i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntime_out) return;
  const float* yb = y + (long long)batch_of_dm[dm] * nsub * t1_len;
  float acc = 0.0f;
  for (int s = 0; s < nsub; ++s)
    acc += __ldg(&yb[(long long)s * t1_len + t + sd[s]]);
  out[(long long)dm * ntime_out + t] = acc;
}

}  // namespace

// fbT f32 (nchan, ntime) zapped, channel-major; rel i32 (nbatch, nchan);
// y f32 (nbatch, nsub, t1_len) out.  Returns cudaGetLastError().
extern "C" int vf_dedisp_stage1(const void* fbT, int ntime, int nchan,
                                int nsub, const void* rel, int nbatch,
                                int t1_len, void* y, void* stream) {
  const int w = nchan / nsub;
  dim3 grid(nbatch, (t1_len + kThreads - 1) / kThreads, nsub);
  stage1_kernel<<<grid, kThreads, w * sizeof(int), (cudaStream_t)stream>>>(
      (const float*)fbT, ntime, nchan, w, (const int*)rel, t1_len, nsub,
      (float*)y);
  return (int)cudaGetLastError();
}

// y f32 (nbatch, nsub, t1_len); sub_delays i32 (ndm, nsub) with every
// t + delay < t1_len; batch_of_dm i32 (ndm,); out f32 (ndm, ntime_out).
extern "C" int vf_dedisp_stage2(const void* y, int nsub, int t1_len,
                                const void* sub_delays,
                                const void* batch_of_dm, int ndm,
                                int ntime_out, void* out, void* stream) {
  dim3 grid((ntime_out + kThreads - 1) / kThreads, ndm);
  stage2_kernel<<<grid, kThreads, nsub * sizeof(int), (cudaStream_t)stream>>>(
      (const float*)y, nsub, t1_len, (const int*)sub_delays,
      (const int*)batch_of_dm, ntime_out, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* vf_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
