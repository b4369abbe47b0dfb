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
// flops a row, far below the f32 line: it is bound by launch latency.
// The design: one warp per cell row, eight rows to a block, so even
// the per-frame call spreads over 13 blocks; each lane reads every
// 32nd channel (the warp's loads of a row are coalesced), the lanes'
// partial sums meet by __shfl_xor_sync, and lane 0 writes the score
// and the positive.  w and b stay device pointers (reading them on the
// host would synchronise); the threshold comes by value.
//
// Numerics: the logit is summed in warp-shuffle order, not XLA's
// einsum order, and the sigmoid is 1 / (1 + expf(-x)) with the
// correctly rounded expf (no fast math).  Scores differ from the plain
// version by an ulp or two, so a cell within a few ulps of the
// threshold may flip; ops.check_scores bounds that.  pos is score >
// threshold, strictly, as the reference compares.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32) proxy_score_kernel(
    const float* __restrict__ feat,  // (rows, C)
    const float* __restrict__ w,     // (C,)
    const float* __restrict__ b,     // (1,)
    float threshold,
    float* __restrict__ scores,      // (rows,)
    int8_t* __restrict__ pos,        // (rows,)
    int rows, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* f = feat + (size_t)row * C;
  float acc = 0.f;
  for (int c = lane; c < C; c += 32) acc = fmaf(f[c], w[c], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float s = 1.0f / (1.0f + expf(-(acc + b[0])));
    scores[row] = s;
    pos[row] = s > threshold ? 1 : 0;
  }
}

}  // namespace

extern "C" int proxy_score_launch(const float* feat, const float* w,
                                  const float* b, float threshold,
                                  float* scores, int8_t* pos, int rows,
                                  int C, void* stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  proxy_score_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      feat, w, b, threshold, scores, pos, rows, C);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
