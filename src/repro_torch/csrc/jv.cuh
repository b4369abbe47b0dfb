// Jonker-Volgenant min-cost assignment on one square f32 cost matrix, run
// by ONE warp: the CUDA port of the JAX package's
//   src/repro/kernels/assign/kernel.py::solve_one
// with its exact update order, so that on the same matrix it returns the
// same permutation as solve_one and the host twin solve_device_np:
//
//   * 1-indexed potentials u (rows), v (columns), p[j] = row matched to
//     column j, column 0 the dummy start of each augmenting path;
//   * cur = (a[i0] - u[i0]) - v, subtracted in that order, every sum and
//     difference rounded on its own (__fadd_rn / __fsub_rn);
//   * the argmin over free columns is the FIRST index of the minimum;
//   * ``eff`` restricts the solve to the leading (eff, eff) square: rows
//     past it do nothing, columns past it never enter an argmin (their
//     minv/way are never read, so they are not computed), and rows
//     without a column report column 0.
//
// Each lane owns the columns j = lane, lane + 32, ...; the per-column
// state lives in shared memory and the argmin is a warp butterfly
// reduction.  The search is sequential by nature (one augmenting path
// per row), so a warp is the right width for it.  Every loop is capped at
// eff + 1 steps, which finite costs never reach; a solve that hits a cap
// stops and returns false, and the caller raises an error flag.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace jv {

struct Scratch {
  float* u;
  float* v;
  float* minv;
  int* p;
  int* way;
  unsigned char* used;
};

// shared-memory bytes of the scratch for an n-column solve
__host__ __device__ inline size_t scratch_bytes(int n) {
  return (size_t)(n + 1) * (3 * sizeof(float) + 2 * sizeof(int) + 1);
}

__device__ inline Scratch carve(unsigned char* base, int n) {
  Scratch s;
  s.u = reinterpret_cast<float*>(base);
  s.v = s.u + (n + 1);
  s.minv = s.v + (n + 1);
  s.p = reinterpret_cast<int*>(s.minv + (n + 1));
  s.way = s.p + (n + 1);
  s.used = reinterpret_cast<unsigned char*>(s.way + (n + 1));
  return s;
}

constexpr unsigned kFull = 0xffffffffu;

// cost: (n, n) row-major with leading dimension ld, finite f32, read-only
// for the call.  col_of: n ints (shared or global) -> column per row.
// Called by all 32 lanes of one warp.  Returns false on a capped loop.
__device__ inline bool solve_warp(const float* __restrict__ cost, int n,
                                  int ld, int eff, Scratch s,
                                  int* __restrict__ col_of) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j <= n; j += 32) {
    s.u[j] = 0.0f;
    s.v[j] = 0.0f;
    s.p[j] = 0;
  }
  __syncwarp();
  bool ok = true;
  for (int i = 1; i <= eff && ok; ++i) {
    for (int j = lane; j <= eff; j += 32) {
      s.minv[j] = CUDART_INF_F;
      s.used[j] = 0;
      s.way[j] = 0;
    }
    if (lane == 0) s.p[0] = i;
    __syncwarp();
    int j0 = 0;
    int steps = 0;
    while (s.p[j0] != 0) {
      if (++steps > eff + 1) {
        ok = false;
        break;
      }
      if (lane == 0) s.used[j0] = 1;
      __syncwarp();
      const int i0 = s.p[j0];
      const float ui0 = s.u[i0];
      const float* row = cost + (size_t)(i0 - 1) * ld;
      float best = CUDART_INF_F;
      int bj = 0x7fffffff;
      for (int j = lane; j <= eff; j += 32) {
        if (s.used[j]) continue;
        // column 0 is used from the first step on, so j >= 1 here
        const float cur = __fsub_rn(__fsub_rn(__ldg(row + j - 1), ui0),
                                    s.v[j]);
        if (cur < s.minv[j]) {
          s.minv[j] = cur;
          s.way[j] = j0;
        }
        if (s.minv[j] < best) {       // ascending j: first index kept
          best = s.minv[j];
          bj = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (ob < best || (ob == best && oj < bj)) {
          best = ob;
          bj = oj;
        }
      }
      // no finite free column: argmin over all-inf is index 0 (as
      // jnp.argmin), which is used, so the cap ends the search
      const int j1 = bj <= eff ? bj : 0;
      const float delta = best;
      __syncwarp();
      for (int j = lane; j <= eff; j += 32) {
        if (s.used[j]) {
          const int r = s.p[j];           // matched rows are distinct
          s.u[r] = __fadd_rn(s.u[r], delta);
          s.v[j] = __fsub_rn(s.v[j], delta);
        } else {
          s.minv[j] = __fsub_rn(s.minv[j], delta);
        }
      }
      __syncwarp();
      j0 = j1;
    }
    if (!ok) break;
    if (lane == 0) {                      // augment along way[]
      int hops = 0;
      while (j0 != 0) {
        if (++hops > eff + 1) {
          ok = false;
          break;
        }
        const int j1 = s.way[j0];
        s.p[j0] = s.p[j1];
        j0 = j1;
      }
    }
    ok = __shfl_sync(kFull, ok, 0);
    __syncwarp();
  }
  // invert p: rows that own no column (past eff) report column 0
  for (int j = lane; j < n; j += 32) col_of[j] = 0;
  __syncwarp();
  for (int j = lane + 1; j <= n; j += 32) {
    const int r = s.p[j];
    if (r > 0) col_of[r - 1] = j - 1;
  }
  __syncwarp();
  return ok;
}

}  // namespace jv
