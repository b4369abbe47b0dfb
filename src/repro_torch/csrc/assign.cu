// Batched min-cost assignment: K square f32 cost matrices -> the matched
// column per row, one block per matrix, its first warp solving (jv.cuh).
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/assign/kernel.py::assign_pallas (body solve_one),
// which runs one grid cell per matrix with the matrix in VMEM.
//
// Bound on an H100: the solve is a sequence of dependent steps (one
// augmenting path per row, one argmin per step), so neither bytes (the
// matrix is read once from device memory, 4 N^2 bytes) nor operations
// bound it: it is latency-bound, the latency of one step times the
// steps.  The design keeps a matrix to one warp, so a step's argmin needs
// no block barrier, and runs the K matrices on K SMs at once.  Up to
// jv::kRegMaxN = 287 columns (every matrix the batch MOTA solves) the
// block's 256 threads first stage the matrix into shared memory and the
// warp keeps the per-column state in registers (jv::solve_staged);
// larger matrices (up to MAX_N = 2048) take jv::solve_warp, with the
// state in shared memory.  The launcher picks by n alone.  Built with
// -fmad=false (see _build.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "jv.cuh"

namespace {

constexpr int kStageThreads = 256;

__global__ void __launch_bounds__(kStageThreads)
assign_kernel(const float* __restrict__ costs, int32_t* __restrict__ out,
              int32_t* __restrict__ err, int n, int eff,
              size_t stage_bytes) {
  extern __shared__ __align__(16) float cs[];
  const size_t k = blockIdx.x;
  const jv::Square sq = jv::stage_square(costs + k * n * n, n, eff,
                                         stage_bytes, cs);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const bool ok = jv::solve_staged(sq, eff, n, out + k * n);
  if (!ok && threadIdx.x == 0) atomicOr(err, 1);
}

__global__ void assign_large_kernel(const float* __restrict__ costs,
                                    int32_t* __restrict__ out,
                                    int32_t* __restrict__ err, int n,
                                    int eff) {
  extern __shared__ __align__(16) unsigned char smem[];
  const jv::Scratch s = jv::carve(smem, n);
  const size_t k = blockIdx.x;
  const bool ok = jv::solve_warp(costs + k * n * n, n, n, eff, s,
                                 out + k * n);
  if (!ok && threadIdx.x == 0) atomicOr(err, 1);
}

}  // namespace

extern "C" int assign_launch(const float* costs, int32_t* out, int32_t* err,
                             int K, int n, int eff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= jv::kRegMaxN) {
    const size_t smem = jv::square_bytes(eff);
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    assign_kernel<<<K, kStageThreads, smem, s>>>(costs, out, err, n, eff,
                                                 smem);
  } else {
    assign_large_kernel<<<K, 32, jv::scratch_bytes(n), s>>>(costs, out,
                                                            err, n, eff);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
