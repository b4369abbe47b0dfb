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
// Bound on an H100: a pure copy, so it is bound by bytes: each distinct
// frame pixel the windows cover is read once (windows of one call may
// overlap) and each window pixel written once, at 3.35 TB/s; at the main
// path's shapes (4 to 8 windows of 240x144 or 480x272 px, C = 3) that is
// at most 3.3-25 MB, 1-7.5 us at the memory line, so small calls are bound by
// latency: the round trips to device memory that a block waits for in
// turn.
//
// One kernel body serves both ops: one block per (window, band of
// rows).  A table type yields each window's origin: the batch op's (n,
// 3) (frame, cy, cx) rows, or the single-frame op's (n, 2) (cy, cx) rows
// at frame 0.  Its rows come either from device memory or, for a table
// that lies on the host (the executor's and the per-frame engine's) with
// at most kMaxRows rows, as a kernel parameter (the ``*_rows_launch``
// launchers): the launch itself carries the rows to the card, as the
// TPU kernel's scalar prefetch did, so a block's first load from device
// memory is its frame rows, not its table row, and the caller makes no
// host-to-device copy of the table.  Each block clamps its origin as the
// reference oracle does (``dynamic_slice``); padding rows of the table
// are zeros and crop frame 0 at cell (0, 0), exactly as the reference
// does.  Where every window row starts and ends on 16 bytes (always at
// C = 3 with 16-px cells), each thread issues all of its kVecs 16-byte
// loads of the band before its first store, stepping from float4 to
// float4 without a division, so a block waits for one round trip to
// device memory, not one a row.  The band is as many rows as kThreads *
// kVecs = 2048 float4s hold (11 rows of a (15, 9) window of 180 float4s
// a row: 14 bands; 5 rows of a (30, 17) one: 55 bands), and a longer
// band repeats the wave.
// Unaligned rows take window_gather_batch_kernel_scalar: a block a
// window row, a thread a float.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVecs = 16;  // 16-byte loads a thread holds in flight
constexpr int kMaxRows = 16;  // table rows a launch can carry

// a window's table row as (frame, cy, cx) in cell units
struct Row {
  int b, cy, cx;
};

// the batch op's (n, 3) table of (frame, cy, cx) rows: in device
// memory, or a host table's rows passed by value
struct DeviceTable {
  const int32_t* p;
  __device__ Row row(int w) const { return {p[3 * w], p[3 * w + 1],
                                            p[3 * w + 2]}; }
};
struct HostRows {
  int32_t v[kMaxRows][3];
  __device__ Row row(int w) const { return {v[w][0], v[w][1], v[w][2]}; }
};
// the single-frame op's (n, 2) table of (cy, cx) rows, always frame 0
struct FrameTable {
  const int32_t* p;
  __device__ Row row(int w) const { return {0, p[2 * w], p[2 * w + 1]}; }
};
struct FrameRows {
  int32_t v[kMaxRows][2];
  __device__ Row row(int w) const { return {0, v[w][0], v[w][1]}; }
};

// the window's origin in the chunk, clamped as the reference does
struct Origin {
  int b, y, x;
};
__device__ __forceinline__ Origin clamp_origin(Row r, int B, int H, int W,
                                               int win_h, int win_w,
                                               int cell) {
  return {min(max(r.b, 0), B - 1), min(max(r.cy * cell, 0), H - win_h),
          min(max(r.cx * cell, 0), W - win_w)};
}

// rows 16-byte aligned: blockIdx.x = band of rows [band * rows_per, ...),
// blockIdx.y = window; every thread's float4 loads before its stores
template <typename Table>
__global__ void __launch_bounds__(kThreads) window_gather_batch_kernel(
    const float* __restrict__ frames,  // (B, H, W, C)
    const __grid_constant__ Table table,
    float* __restrict__ out,           // (n, win_h, win_w, C)
    int B, int H, int W, int C, int win_h, int win_w, int cell,
    int rows_per) {
  const int win = blockIdx.y;
  const int r0 = blockIdx.x * rows_per;
  const int rows = min(rows_per, win_h - r0);
  const Origin o = clamp_origin(table.row(win), B, H, W, win_h, win_w, cell);
  const int n = win_w * C / 4;  // float4s a window row
  const size_t pitch = (size_t)W * C / 4;
  const float4* src = reinterpret_cast<const float4*>(
      frames + ((size_t)o.b * H + o.y + r0) * W * C + (size_t)o.x * C);
  float4* dst = reinterpret_cast<float4*>(out) +
                ((size_t)win * win_h + r0) * n;
  const int total = rows * n;
  // a step of kThreads float4s is dr rows and dc columns
  const int dr = kThreads / n, dc = kThreads - dr * n;
  for (int base = 0; base < total; base += kThreads * kVecs) {
    // the thread's first float4 (row r, column c), then a step at a
    // time, without a division
    int r = (base + threadIdx.x) / n;
    int c = base + threadIdx.x - r * n;
    float4 v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (base + threadIdx.x + k * kThreads < total) v[k] = src[r * pitch + c];
      r += dr;
      c += dc;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = base + threadIdx.x + k * kThreads;
      if (i < total) dst[i] = v[k];
    }
  }
}

// rows not 16-byte aligned: a block a window row (blockIdx.x), a thread
// a float
template <typename Table>
__global__ void window_gather_batch_kernel_scalar(
    const float* __restrict__ frames, const __grid_constant__ Table table,
    float* __restrict__ out, int B, int H, int W, int C, int win_h,
    int win_w, int cell) {
  const int win = blockIdx.y;
  const int r = blockIdx.x;
  const Origin o = clamp_origin(table.row(win), B, H, W, win_h, win_w, cell);
  const float* src = frames + (((size_t)o.b * H + o.y + r) * W + o.x) * C;
  float* dst = out + ((size_t)win * win_h + r) * (size_t)win_w * C;
  for (int i = threadIdx.x; i < win_w * C; i += blockDim.x) dst[i] = src[i];
}

// threads of a scalar block: a window row's floats, in whole warps
int row_threads(int win_w, int C) {
  const int threads = ((win_w * C + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > 256 ? 256 : threads);
}

template <typename Table>
int launch_batch(const float* frames, const Table& table, float* out, int n,
                 int B, int H, int W, int C, int win_h, int win_w, int cell,
                 int vec4, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    // the rows that one wave of the block's loads holds
    const int rows_per =
        max(1, min(win_h, kThreads * kVecs * 4 / (win_w * C)));
    const dim3 grid((win_h + rows_per - 1) / rows_per, n);
    window_gather_batch_kernel<Table><<<grid, kThreads, 0, s>>>(
        frames, table, out, B, H, W, C, win_h, win_w, cell, rows_per);
  } else {
    window_gather_batch_kernel_scalar<Table>
        <<<dim3(win_h, n), row_threads(win_w, C), 0, s>>>(
            frames, table, out, B, H, W, C, win_h, win_w, cell);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table: (n, 3) int32 on the device
extern "C" int window_gather_batch_launch(const float* frames,
                                          const int32_t* table, float* out,
                                          int n, int B, int H, int W, int C,
                                          int win_h, int win_w, int cell,
                                          int vec4, void* stream) {
  return launch_batch(frames, DeviceTable{table}, out, n, B, H, W, C, win_h,
                      win_w, cell, vec4, stream);
}

// table: (n, 3) int32 in host memory, n <= kMaxRows; read before return
extern "C" int window_gather_batch_rows_launch(const float* frames,
                                               const int32_t* table,
                                               float* out, int n, int B,
                                               int H, int W, int C,
                                               int win_h, int win_w,
                                               int cell, int vec4,
                                               void* stream) {
  if (n > kMaxRows) return (int)cudaErrorInvalidValue;
  HostRows rows;
  memcpy(rows.v, table, (size_t)n * sizeof(rows.v[0]));
  return launch_batch(frames, rows, out, n, B, H, W, C, win_h, win_w, cell,
                      vec4, stream);
}

// the single-frame op: frame (H, W, C), origins (n, 2) int32 (cy, cx)
// on the device
extern "C" int window_gather_launch(const float* frame,
                                    const int32_t* origins, float* out,
                                    int n, int H, int W, int C, int win_h,
                                    int win_w, int cell, int vec4,
                                    void* stream) {
  return launch_batch(frame, FrameTable{origins}, out, n, 1, H, W, C, win_h,
                      win_w, cell, vec4, stream);
}

// origins: (n, 2) int32 in host memory, n <= kMaxRows; read before
// return
extern "C" int window_gather_rows_launch(const float* frame,
                                         const int32_t* origins, float* out,
                                         int n, int H, int W, int C,
                                         int win_h, int win_w, int cell,
                                         int vec4, void* stream) {
  if (n > kMaxRows) return (int)cudaErrorInvalidValue;
  FrameRows rows;
  memcpy(rows.v, origins, (size_t)n * sizeof(rows.v[0]));
  return launch_batch(frame, rows, out, n, 1, H, W, C, win_h, win_w, cell,
                      vec4, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
