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
//   * the argmin over free columns is the FIRST index of the minimum,
//     -0.0 and +0.0 equal (as `<` and jnp.argmin treat them); an argmin
//     over no finite value is index 0, as jnp.argmin's over all-inf;
//   * ``eff`` restricts the solve to the leading (eff, eff) square: rows
//     past it do nothing, columns past it never enter an argmin (their
//     minv/way are never read, so they are not computed), and rows
//     without a column report column 0.
//
// The search is sequential by nature (one augmenting path per row, one
// argmin per step), so a warp is the right width for it and the time is
// the latency of one step times the steps (about eff + 1 a row on the
// tracker's FORBIDDEN_DEVICE-padded squares).  Every loop is capped at
// eff + 1 steps, which finite costs never reach; a solve that hits a cap
// stops and returns false, and the caller raises an error flag.  An
// all-inf step (non-finite costs) picks column 0, which is used, so every
// later step of that row does too (its free minv are NaN, which no `<`
// takes) until the cap.
//
// Two instances, chosen by the matrix size n alone (never on failure):
//
// solve_regs<S, Partial> (n <= kRegMaxN = 287, every square the tracker
//   solves up to Q 256): the cost square is staged into shared memory
//   once per solve by the whole block (stage_square), so a step reads
//   row i0 there, one conflict-free word a lane; past kStageBytes (eff >
//   239, Partial) the rows that do not fit are read from device memory.
//   Lane l owns columns j = l + 32 s, s < S, and keeps
//   their v, minv, way, the row p[j] and that row's potential
//   uc[j] = u[p[j]] in registers, with a bit mask of used columns.  uc is
//   exact: only rows on used columns are updated, each once a step, so
//   u[p[j]] += delta is uc[j] += delta; column 0 carries the current row,
//   whose u is still 0 when its search starts; and the augmentation's
//   p[j0] = p[j1] moves the row's potential with it (uc[j0] = uc[j1]).
//   A step's chain is then: the row's S words read from shared memory
//   at once, two subtractions and a compare a slot (selects, no
//   branches), each lane's first slot holding its least minv, the warp
//   minimum of that value's order-preserving u32 key (__reduce_min_sync,
//   redux.sync: -0 folded to +0, a lane without a finite minv at the key
//   of +inf), a second redux for the lowest column index holding it, and
//   three shuffles from that column's lane (minv with its sign of zero as
//   delta, p, uc) — no __syncwarp, no shared-memory scatter.  The
//   five-level butterfly of paired shuffles it replaces cost ten
//   dependent shuffles.  Measured on an H100 (PERF.md): a key a slot
//   before the lane minimum, branches around the masked slots, or a
//   ballot a slot for the index each made a step slower, and carrying
//   the winner's row in the index redux saved under 1%.  The augmenting
//   path is walked by the whole warp, a warp-uniform shuffle of way[] per
//   hop.  S = ceil((eff + 1) / 32) is a template parameter, picked per
//   solve from eff (the same arithmetic at every S; only the dead slots
//   go).
// solve_warp (larger n, up to assign's MAX_N = 2048, 65 slots a lane, too
//   many registers; track_step past Q 256): the per-column state in
//   shared memory, the cost rows read through the read-only cache, a
//   butterfly argmin; the same answers, more latency a step.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace jv {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 9;                 // register solver: <= 288 columns
constexpr int kRegMaxN = 32 * kMaxSlots - 1;  // largest n it takes (287)
// shared memory a block stages the square into, within the 227 KB a
// block may have (the rest holds col_of)
constexpr int kStageBytes = 224 * 1024;

// u32 key whose unsigned order is the float order of a non-NaN x, with
// -0.0 and +0.0 on one key (so a tie between them goes to the lower
// index): x + 0 turns -0 into +0, then negative values flip every bit
// and the others only the sign bit
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

// ---------------------------------------------------------------------------
// Register solver
// ---------------------------------------------------------------------------

// shared-memory bytes of an n-column matrix's staged square (its
// leading eff rows at most)
__host__ __device__ inline size_t square_bytes(int n) {
  const size_t all = (size_t)n * n * sizeof(float);
  return all < (size_t)kStageBytes ? all : (size_t)kStageBytes;
}

// the square a solve reads: its leading ``rows`` rows staged in shared
// memory (leading dimension eff), the others in device memory
struct Square {
  const float* cs;
  int rows;
  const float* cost;       // the (n, n) matrix, leading dimension ld
  int ld;
};

// copy the leading rows of the (eff, eff) square of ``cost`` (leading
// dimension ld) that fit in ``stage_bytes`` into ``cs`` with every
// thread of the block, kStageBatch loads in flight a thread (the matrix
// comes from device memory, whose latency a load-store loop would pay
// once a word); the caller synchronises the block after it
constexpr int kStageBatch = 16;

__device__ inline Square stage_square(const float* __restrict__ cost,
                                      int ld, int eff, size_t stage_bytes,
                                      float* __restrict__ cs) {
  const int rows = eff == 0 ? 0
                   : min(eff, (int)(stage_bytes / sizeof(float) / eff));
  const int n = rows * eff;
  for (int i0 = threadIdx.x; i0 < n; i0 += kStageBatch * blockDim.x) {
    float t[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / eff, c = i - r * eff;
      t[u] = i < n ? __ldg(cost + (size_t)r * ld + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) cs[i] = t[u];
    }
  }
  return Square{cs, rows, cost, ld};
}

// a[s] for a warp-uniform s, the array kept in registers (an unrolled
// select: a dynamic index would move it to local memory)
template <typename T, int S>
__device__ __forceinline__ T pick(const T (&a)[S], int s) {
  T x = a[0];
#pragma unroll
  for (int t = 1; t < S; ++t)
    if (s == t) x = a[t];
  return x;
}

// sq: the (eff, eff) square, eff + 1 <= 32 S, all of it staged unless
// ``Partial`` (a branch a step on the row's place, kept off the common
// sizes' chain).  col_of: n ints (shared or global) -> column per row.
// Called by all 32 lanes of one warp.  Returns false on a capped loop.
template <int S, bool Partial>
__device__ bool solve_regs(Square sq, int eff, int n,
                           int* __restrict__ col_of) {
  const int lane = threadIdx.x & 31;
  float v[S], minv[S], uc[S];
  int pc[S], way[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = 0.0f;
    uc[s] = 0.0f;
    pc[s] = 0;
  }
  bool ok = true;
  for (int i = 1; i <= eff && ok; ++i) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      minv[s] = CUDART_INF_F;
      way[s] = 0;
    }
    unsigned used = 0;                    // bit s: column lane + 32 s
    if (lane == 0) {                      // column 0 starts row i's path
      pc[0] = i;
      uc[0] = 0.0f;
    }
    int j0 = 0, i0 = i;                   // warp-uniform
    float ui0 = 0.0f;
    int steps = 0;
    while (true) {
      if (++steps > eff + 1) {
        ok = false;
        break;
      }
      used |= lane == (j0 & 31) ? 1u << (j0 >> 5) : 0u;
      // row i0, every slot's word read at once (an in-range column stands
      // in for the masked ones), then selects, not branches
      float a[S];
      if (!Partial || i0 <= sq.rows) {
        const float* row = sq.cs + (size_t)(i0 - 1) * eff - 1;  // row[j]
#pragma unroll
        for (int s = 0; s < S; ++s)
          a[s] = row[min(max(lane + 32 * s, 1), eff)];
      } else {
        const float* row = sq.cost + (size_t)(i0 - 1) * sq.ld - 1;
#pragma unroll
        for (int s = 0; s < S; ++s)
          a[s] = __ldg(row + min(max(lane + 32 * s, 1), eff));
      }
      // this lane's first slot holding its least finite minv (`<` ties
      // -0.0 and +0.0 and takes no NaN); masked slots (used, column 0,
      // past eff) never win, and a lane without a finite one offers slot
      // 0 at the key of +inf
      int bs = 0;
      float bval = CUDART_INF_F;
      int bpc = pc[0];
      float buc = uc[0];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = lane + 32 * s;
        const bool act = !((used >> s) & 1u) && j >= 1 && j <= eff;
        const float cur = __fsub_rn(__fsub_rn(a[s], ui0), v[s]);
        const bool take = act && cur < minv[s];
        minv[s] = take ? cur : minv[s];
        way[s] = take ? j0 : way[s];
        const bool better = act && minv[s] < bval;
        bs = better ? s : bs;
        bval = better ? minv[s] : bval;
        bpc = better ? pc[s] : bpc;
        buc = better ? uc[s] : buc;
      }
      const unsigned bk = order_key(bval);    // +inf above every finite
      const unsigned kmin = __reduce_min_sync(kFull, bk);
      const unsigned cand = bk == kmin ? (unsigned)(bs * 32 + lane)
                                       : 0xffffffffu;
      const int j1 = (int)__reduce_min_sync(kFull, cand);
      const int src = j1 & 31;
      const float delta = __shfl_sync(kFull, bval, src);
      const int p1 = __shfl_sync(kFull, bpc, src);
      const float u1 = __shfl_sync(kFull, buc, src);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = lane + 32 * s;
        const bool u_s = (used >> s) & 1u;
        const float ucn = __fadd_rn(uc[s], delta);
        const float vn = __fsub_rn(v[s], delta);
        const float mn = __fsub_rn(minv[s], delta);
        uc[s] = u_s ? ucn : uc[s];
        v[s] = u_s ? vn : v[s];
        minv[s] = !u_s && j >= 1 && j <= eff ? mn : minv[s];
      }
      j0 = j1;
      i0 = p1;
      ui0 = u1;
      if (p1 == 0) break;                 // a free column ends the path
    }
    if (!ok) break;
    // augment along way[]: p[j0] = p[j1] (and the row's potential with
    // it), the whole warp walking the path
    int hops = 0;
    while (j0 != 0) {
      if (++hops > eff + 1) {
        ok = false;
        break;
      }
      const int s0 = j0 >> 5;
      const int j1 = __shfl_sync(kFull, pick(way, s0), j0 & 31);
      const int s1 = j1 >> 5;
      const int p1 = __shfl_sync(kFull, pick(pc, s1), j1 & 31);
      const float u1 = __shfl_sync(kFull, pick(uc, s1), j1 & 31);
      if (lane == (j0 & 31)) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (s == s0) {
            pc[s] = p1;
            uc[s] = u1;
          }
      }
      j0 = j1;
    }
  }
  // invert p: rows that own no column (past eff) report column 0
  for (int j = lane; j < n; j += 32) col_of[j] = 0;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = lane + 32 * s;
    if (j >= 1 && j <= eff && pc[s] > 0) col_of[pc[s] - 1] = j - 1;
  }
  __syncwarp();
  return ok;
}

// the register solver at the fewest slots that hold eff + 1 columns;
// eff <= kRegMaxN
__device__ inline bool solve_staged(Square sq, int eff, int n,
                                    int* __restrict__ col_of) {
  // only eff >= 240 (8 or 9 slots) overflows kStageBytes
  switch ((eff + 32) / 32) {
    case 1: return solve_regs<1, false>(sq, eff, n, col_of);
    case 2: return solve_regs<2, false>(sq, eff, n, col_of);
    case 3: return solve_regs<3, false>(sq, eff, n, col_of);
    case 4: return solve_regs<4, false>(sq, eff, n, col_of);
    case 5: return solve_regs<5, false>(sq, eff, n, col_of);
    case 6: return solve_regs<6, false>(sq, eff, n, col_of);
    case 7: return solve_regs<7, false>(sq, eff, n, col_of);
    case 8: return sq.rows == eff ? solve_regs<8, false>(sq, eff, n, col_of)
                                  : solve_regs<8, true>(sq, eff, n, col_of);
    default: return solve_regs<9, true>(sq, eff, n, col_of);
  }
}

// ---------------------------------------------------------------------------
// Shared-memory solver (n > kRegMaxN)
// ---------------------------------------------------------------------------

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
