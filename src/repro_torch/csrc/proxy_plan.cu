// Fused proxy plan: head matvec + bias, sigmoid, threshold, span-count
// map onto the detector grid, and per-frame plan stats.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/proxy_plan/kernel.py::proxy_plan_pallas
//   (body _plan_kernel).
//
// Bound on an H100: at the main path's shapes (feat (16, 8, 13, 64) f32
// -> grid (16, 34, 60) int8 + stats (16, 8) int32) the call moves about
// 0.46 MB and does about 0.2 MFLOP, so the card could finish it in well
// under a microsecond: it is bound by launch latency, far below both the
// memory and the tensor-core line.  The design therefore does the whole
// plan in ONE launch with one block per frame, keeps every intermediate
// (cell positives, row span counts) in shared memory, reads each feature
// row once with coalesced warp loads, and writes only the int8 grid and
// the stats row.  No tensor cores: the products are tiny.
//
// Numerics: the logit is a 64-term dot in warp-shuffle order (not the
// reference's order), and the sigmoid is 1 / (1 + expf(-x)) with the
// accurate expf (no fast math).  A cell whose sigmoid sits within a few
// ulp of the threshold can therefore flip against the plain version;
// the tests and chip_smoke.py count such flips and check that each one
// lies within that band.  Span counts are sums of 0/1 products, exact in
// f32, so the mapping and stats are exact given the positives.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStatsW = 8;  // [count, ymin, ymax, xmin, xmax, 0, 0, 0]

__global__ void __launch_bounds__(kThreads) proxy_plan_kernel(
    const float* __restrict__ feat,    // (B, hp, wp, C)
    const float* __restrict__ w,       // (C,)
    const float* __restrict__ b,       // (1,)
    float threshold,
    const float* __restrict__ span_y,  // (hc, hp) 0/1
    const float* __restrict__ span_x,  // (wc, wp) 0/1
    int8_t* __restrict__ grid,         // (B, hc, wc)
    int32_t* __restrict__ stats,       // (B, kStatsW)
    int hp, int wp, int C, int hc, int wc) {
  extern __shared__ float smem[];
  float* pos = smem;               // (hp, wp) cell positives, 0/1
  float* rows = smem + hp * wp;    // (hc, wp) span_y @ pos
  __shared__ int s_count, s_ymin, s_ymax, s_xmin, s_xmax;

  const int frame = blockIdx.x;
  const int n_cells = hp * wp;
  const float* f = feat + (size_t)frame * n_cells * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    s_count = 0;
    s_ymin = hc;
    s_ymax = -1;
    s_xmin = wc;
    s_xmax = -1;
  }

  // 1. head: one warp per proxy cell, lanes stride the channels
  const float bias = b[0];
  for (int cell = warp; cell < n_cells; cell += n_warps) {
    const float* fc = f + (size_t)cell * C;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) acc = fmaf(fc[c], w[c], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float s = 1.0f / (1.0f + expf(-(acc + bias)));
      pos[cell] = s > threshold ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  // 2. rows = span_y @ pos   (hc, wp)
  for (int i = threadIdx.x; i < hc * wp; i += blockDim.x) {
    const int y = i / wp, xp = i - (i / wp) * wp;
    float acc = 0.f;
    for (int h = 0; h < hp; ++h) acc += span_y[y * hp + h] * pos[h * wp + xp];
    rows[i] = acc;
  }
  __syncthreads();

  // 3. cnt = rows @ span_x^T (hc, wc); mapped = cnt > 0.5; stats
  int count = 0, ymin = hc, ymax = -1, xmin = wc, xmax = -1;
  int8_t* g = grid + (size_t)frame * hc * wc;
  for (int i = threadIdx.x; i < hc * wc; i += blockDim.x) {
    const int y = i / wc, x = i - (i / wc) * wc;
    float acc = 0.f;
    for (int k = 0; k < wp; ++k) acc += rows[y * wp + k] * span_x[x * wp + k];
    const bool mapped = acc > 0.5f;
    g[i] = mapped ? 1 : 0;
    if (mapped) {
      ++count;
      ymin = min(ymin, y);
      ymax = max(ymax, y);
      xmin = min(xmin, x);
      xmax = max(xmax, x);
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  ymin = __reduce_min_sync(0xffffffffu, ymin);
  ymax = __reduce_max_sync(0xffffffffu, ymax);
  xmin = __reduce_min_sync(0xffffffffu, xmin);
  xmax = __reduce_max_sync(0xffffffffu, xmax);
  if (lane == 0) {
    atomicAdd(&s_count, count);
    atomicMin(&s_ymin, ymin);
    atomicMax(&s_ymax, ymax);
    atomicMin(&s_xmin, xmin);
    atomicMax(&s_xmax, xmax);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t* st = stats + (size_t)frame * kStatsW;
    st[0] = s_count;
    st[1] = s_ymin;
    st[2] = s_ymax;
    st[3] = s_xmin;
    st[4] = s_xmax;
    st[5] = 0;
    st[6] = 0;
    st[7] = 0;
  }
}

}  // namespace

extern "C" int proxy_plan_smem_bytes(int hp, int wp, int hc) {
  return (hp * wp + hc * wp) * (int)sizeof(float);
}

extern "C" int proxy_plan_launch(const float* feat, const float* w,
                                 const float* b, float threshold,
                                 const float* span_y, const float* span_x,
                                 int8_t* grid, int32_t* stats, int B, int hp,
                                 int wp, int C, int hc, int wc,
                                 void* stream) {
  const int smem = proxy_plan_smem_bytes(hp, wp, hc);
  proxy_plan_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      feat, w, b, threshold, span_y, span_x, grid, stats, hp, wp, C, hc, wc);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
