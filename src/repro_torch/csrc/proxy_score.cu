// Proxy head over a score map: 1x1 matvec + bias, sigmoid, and the
// strict threshold, one output pair (score, positive) per proxy cell.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/proxy_score/kernel.py::proxy_score_pallas
//   (body _head_kernel).
//
// Bound on an H100: at the shapes it serves (feat (1, 8, 13, 64) f32 =
// 104 cell rows on the per-frame path, (16, 8, 13, 64) = 1664 rows for
// a chunk with fused_plan=False) the call reads 27-426 KB and writes
// 5 bytes a row, 8 ns to 0.13 us at 3.35 TB/s, and does 2 * C + a few
// flops a row, far below the f32 line: it is bound by launch latency
// and by the round trips to device memory that a warp waits for in
// turn.
// The design: one warp per cell row, eight rows to a block, so even
// the per-frame call spreads over 13 blocks.  Every lane issues all of
// its loads first, on the read-only path: b[0], then its channels of
// feat and w, as float2 where C is even and both rows lie on 8 bytes
// (C 64: one float2 of each a lane) and as scalars otherwise; so a warp
// waits for one round trip to device memory.  The lanes' partial sums
// meet by __shfl_xor_sync; the block's scores and positives gather in
// shared memory and leave as two contiguous runs (8 floats, 8 bytes).
// w and b stay device pointers (reading them on the host would
// synchronise); the threshold comes by value.  The wrapper allocates
// scores and positives in one buffer, so they come back to the host in
// one copy.
//
// Numerics: the logit is each lane's two (or more) fused products, then
// the shuffle tree, not XLA's einsum order, and the sigmoid is 1 / (1 +
// expf(-x)) with the full-accuracy expf (no fast math).  Scores
// differ from the plain version by an ulp or two, so a cell within a
// few ulps of the threshold may flip; ops.check_scores bounds that.
// pos is score > threshold, strictly, as the reference compares.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <bool kVec2>
__global__ void __launch_bounds__(kWarps * 32) proxy_score_kernel(
    const float* __restrict__ feat,  // (rows, C)
    const float* __restrict__ w,     // (C,)
    const float* __restrict__ b,     // (1,)
    float threshold,
    float* __restrict__ scores,      // (rows,)
    int8_t* __restrict__ pos,        // (rows,)
    int rows, int C) {
  __shared__ float s_score[kWarps];
  __shared__ int8_t s_pos[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  const float bias = __ldg(b);
  float acc = 0.f;
  if (row < rows) {
    if (kVec2) {
      const float2* f2 =
          reinterpret_cast<const float2*>(feat + (size_t)row * C);
      const float2* w2 = reinterpret_cast<const float2*>(w);
      const int pairs = C >> 1;
      for (int c = lane; c < pairs; c += 32) {
        const float2 f = __ldg(f2 + c);
        const float2 v = __ldg(w2 + c);
        acc = fmaf(f.x, v.x, acc);
        acc = fmaf(f.y, v.y, acc);
      }
    } else {
      const float* f = feat + (size_t)row * C;
      for (int c = lane; c < C; c += 32)
        acc = fmaf(__ldg(f + c), __ldg(w + c), acc);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float s = 1.0f / (1.0f + expf(-(acc + bias)));
    s_score[warp] = s;
    s_pos[warp] = s > threshold ? 1 : 0;
  }
  __syncthreads();
  const int n = min(kWarps, rows - row0);
  if (threadIdx.x < n) {
    scores[row0 + threadIdx.x] = s_score[threadIdx.x];
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + n) {
    pos[row0 + threadIdx.x - 32] = s_pos[threadIdx.x - 32];
  }
}

}  // namespace

extern "C" int proxy_score_launch(const float* feat, const float* w,
                                  const float* b, float threshold,
                                  float* scores, int8_t* pos, int rows,
                                  int C, void* stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 2 == 0 && (uintptr_t)feat % 8 == 0 && (uintptr_t)w % 8 == 0)
    proxy_score_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        feat, w, b, threshold, scores, pos, rows, C);
  else
    proxy_score_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        feat, w, b, threshold, scores, pos, rows, C);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
