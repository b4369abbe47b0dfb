// Batched min-cost assignment: K square f32 cost matrices -> the matched
// column per row, one warp per matrix (jv.cuh).
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/assign/kernel.py::assign_pallas (body solve_one),
// which runs one grid cell per matrix with the matrix in VMEM.
//
// Bound on an H100: the solve is a sequence of dependent steps (one
// augmenting path per row, one argmin per step), so neither bytes (the
// matrix is read once from device memory, 4 N^2 bytes) nor operations
// bound it: it is latency-bound, a few hundred cycles per step.  The
// design keeps a matrix to one warp, so a step's argmin is five shuffles
// and no block barrier, and runs the K matrices on K SMs at once; the
// matrix rows are read through the read-only cache, where a solve finds
// them again on later steps.  Built with -fmad=false (see _build.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "jv.cuh"

namespace {

__global__ void assign_kernel(const float* __restrict__ costs,
                              int32_t* __restrict__ out,
                              int32_t* __restrict__ err, int n, int eff) {
  extern __shared__ __align__(16) unsigned char smem[];
  const jv::Scratch s = jv::carve(smem, n);
  const size_t k = blockIdx.x;
  const bool ok = jv::solve_warp(costs + k * n * n, n, n, eff, s,
                                 out + k * n);
  if (!ok && threadIdx.x == 0) atomicExch(err, 1);
}

}  // namespace

extern "C" int assign_launch(const float* costs, int32_t* out, int32_t* err,
                             int K, int n, int eff, void* stream) {
  const size_t smem = jv::scratch_bytes(n);
  assign_kernel<<<K, 32, smem, (cudaStream_t)stream>>>(costs, out, err, n,
                                                       eff);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
