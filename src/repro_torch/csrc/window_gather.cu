// Window gathers: crop n windows of one size class out of a chunk of
// frames by a (frame, cy, cx) table, or out of one frame by a (cy, cx)
// table, in cell units.
//
// Replaces the JAX package's TPU kernels
//   src/repro/kernels/window_gather/kernel.py::window_gather_batch_pallas
//   (body _gather_batch_kernel, driven by a scalar-prefetched table), and
//   src/repro/kernels/window_gather/kernel.py::window_gather_pallas
//   (body _gather_kernel, the per-frame path's single-frame crop).
//
// Bound on an H100: a pure copy, so it is bound by bytes — each window
// pixel is read once and written once (2 * n * win_h * win_w * C * 4
// bytes) at 3.35 TB/s; at the main path's shapes (a few to sixteen
// windows of 240x144 or 480x272 px, C = 3) that is 0.8-50 MB, 0.25-15
// us at the memory line, so small calls are launch-bound.  The design: one
// block per (window, window row), so a chunk's call launches thousands
// of blocks and fills the card; each block reads its own table row (no
// scalar prefetch on this card), clamps it as the reference oracle does,
// and copies one contiguous win_w * C run of the frame row with 16-byte
// loads and stores when the row, the window and the cell keep 16-byte
// alignment (always at C = 3 with 16-px cells), scalar otherwise.
// Padding rows of the table are zeros and crop (frame 0) cell (0, 0),
// exactly as the reference does.  Both kernels share the row copy; the
// single-frame one reads a two-column table and has no frame index.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// copy one window row: n floats from src to dst
template <bool kVec4>
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int n) {
  if (kVec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

template <bool kVec4>
__global__ void window_gather_batch_kernel(
    const float* __restrict__ frames,   // (B, H, W, C)
    const int32_t* __restrict__ table,  // (n, 3) frame, cy, cx
    float* __restrict__ out,            // (n, win_h, win_w, C)
    int B, int H, int W, int C, int win_h, int win_w, int cell) {
  const int win = blockIdx.y;
  const int r = blockIdx.x;
  const int32_t* row = table + 3 * win;
  const int b = min(max(row[0], 0), B - 1);
  const int y = min(max(row[1] * cell, 0), H - win_h);
  const int x = min(max(row[2] * cell, 0), W - win_w);
  copy_row<kVec4>(frames + (((size_t)b * H + y + r) * W + x) * C,
                  out + ((size_t)win * win_h + r) * (size_t)win_w * C,
                  win_w * C);
}

template <bool kVec4>
__global__ void window_gather_kernel(
    const float* __restrict__ frame,      // (H, W, C)
    const int32_t* __restrict__ origins,  // (n, 2) cy, cx
    float* __restrict__ out,              // (n, win_h, win_w, C)
    int H, int W, int C, int win_h, int win_w, int cell) {
  const int win = blockIdx.y;
  const int r = blockIdx.x;
  const int32_t* row = origins + 2 * win;
  const int y = min(max(row[0] * cell, 0), H - win_h);
  const int x = min(max(row[1] * cell, 0), W - win_w);
  copy_row<kVec4>(frame + ((size_t)(y + r) * W + x) * C,
                  out + ((size_t)win * win_h + r) * (size_t)win_w * C,
                  win_w * C);
}

int row_threads(int win_w, int C, int vec4) {
  const int per_row = vec4 ? (win_w * C) / 4 : win_w * C;
  const int threads = ((per_row + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > 256 ? 256 : threads);
}

}  // namespace

extern "C" int window_gather_batch_launch(const float* frames,
                                          const int32_t* table, float* out,
                                          int n, int B, int H, int W, int C,
                                          int win_h, int win_w, int cell,
                                          int vec4, void* stream) {
  const int threads = row_threads(win_w, C, vec4);
  const dim3 grid(win_h, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    window_gather_batch_kernel<true><<<grid, threads, 0, s>>>(
        frames, table, out, B, H, W, C, win_h, win_w, cell);
  else
    window_gather_batch_kernel<false><<<grid, threads, 0, s>>>(
        frames, table, out, B, H, W, C, win_h, win_w, cell);
  return (int)cudaGetLastError();
}

extern "C" int window_gather_launch(const float* frame,
                                    const int32_t* origins, float* out,
                                    int n, int H, int W, int C, int win_h,
                                    int win_w, int cell, int vec4,
                                    void* stream) {
  const int threads = row_threads(win_w, C, vec4);
  const dim3 grid(win_h, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    window_gather_kernel<true><<<grid, threads, 0, s>>>(
        frame, origins, out, H, W, C, win_h, win_w, cell);
  else
    window_gather_kernel<false><<<grid, threads, 0, s>>>(
        frame, origins, out, H, W, C, win_h, win_w, cell);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
