// Mamba2's SSD (state-space duality) chunked scan.  x (b, S, H, P), B and
// C (b, S, N) (one group) in f32 or bf16; dt (b, S, H) post-softplus, A
// and D (H,) in f32, A < 0.  Out: y (b, S, H, P) in x's dtype and the
// final state (b, H, P, N) in f32, from a zero state, by chunks of Q <=
// 128 rows (both kernels mask the ragged end themselves: S need not be a
// multiple of Q).  Per chunk, with L the cumulative sum of dt A:
//   y     = [(C B^T) * decay] (dt x) + exp(L) * (C state^T) + D x
//   state = exp(L_Q) state + (x w)^T B,      w = exp(L_Q - L) dt,
// decay[t, j] = exp(L_t - L_j) for j <= t, else 0.  Any chunking gives
// the same y and state up to rounding: the f32 kernel takes steps of 64
// rows whatever Q.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body _ssd_kernel).
//
// Bound on an H100: a chunk of one (row, head) does Q (Q + 1) P flops in
// the intra product (only j <= t), 2 Q P N in C state^T and 2 Q P N in
// the state update; C B^T, Q (Q + 1) N flops a chunk, is head-independent
// with one group, so the function needs it once a (row, chunk).  At the
// serving shape (B 4, S 512, H 32, Q 128, P 64, N 128) that is 2.72 GFLOP
// against 22 MB of bf16 inputs and outputs: 0.0065 ms for the bytes at
// 3.35 TB/s, 0.0028 ms for the operations at the 989 TFLOP/s bf16
// tensor-core peak, 0.041 ms on the CUDA cores' 67 TFLOP/s f32.  So only
// tensor cores come near the bound.
//
// Two kernels, one per dtype, both on tensor cores; ssd_scan_launch
// dispatches on bf16, and a bf16 call never runs the f32 kernel.  Both
// keep the Pallas grid's sequential chunk axis as a loop inside one block
// per (head, batch row) (4 x 32 = 128 blocks at the serving shape, on 132
// SMs), with the state carried on chip in registers.  The chunk-parallel
// form (every chunk's state written to device memory, then a
// state-passing pass, as mamba_ssm's Triton ssd_combined) would add 16.8
// MB of f32 states here, 77% of the call's bf16 bytes, for parallelism B
// 4 does not need; it is the lever for B 1.
//
// bf16: ssd_scan_wgmma_kernel, on tensor cores.  Two warpgroups (256
// threads, one block an SM: 231,440 bytes of shared memory); warpgroup r
// owns chunk rows 64 r .. 64 r + 63 of y and state columns 64 r .. 64 r
// + 63 (the (P, N) = (64, 128) state as an m64n64 f32 accumulator in each
// warpgroup's registers, across chunks).  Thread 0 brings the next
// chunk's x (a 4-D box of 128 rows of one head, rows H P apart), B and C
// (two 64-column panels each) in with TMA, into the second of two 80 KB
// stages behind an mbarrier, while this chunk computes; rows past S land
// as zeros, so S need not be a multiple of Q.  Warp 0 reads dt a chunk
// ahead (4 rows a lane: a TMA box is 16 bytes wide at least) and runs the
// next chunk's scan while the others store y.  Per chunk, every product
// is a bf16 wgmma with f32 accumulators, operands in the 128-byte
// swizzle:
//   G = C B^T (K = N) as m64n64k16 (rows 0-63: only the diagonal tile) or
//     m64n128k16 (rows 64-127), never the tile above the diagonal;
//   y = C state^T (the state's bf16 hi and lo terms, written to shared
//     memory once a chunk), scaled by exp(L) per row in registers, then
//     += M x with M = G * decay * dt built in the G accumulator's
//     registers and fed, hi and lo, as the register A operand (the
//     accumulator's layout is the A operand's, hopper.cuh); + D x,
//     rounded to bf16 once, staged through shared memory (the stage's
//     first C panel, read by then) and stored 16 bytes a thread;
//   state = exp(L_Q) state + (x w)^T B, x w written as hi and lo tiles in
//     x's own layout and read M-major (transposed A), B read N-major.
// Rows t >= Q of a 128-row tile (Q < 128: the tile reaches into the next
// chunk or past S) give zero columns of M (j < Q is part of the mask) and
// zero rows of x w (dt = 0 there), and are not stored.  Where the time
// goes (clock64 over one block in instrumented copies, not kept):
// building M in the second warpgroup is a chunk's longest phase (64
// values a thread against the first's 32, with two warps a scheduler to
// hide their latency; the first writes x w meanwhile), then issuing and
// awaiting the products, then storing y, then the barriers.  Not done:
// chunk c + 1's G and M (which need no state) overlapping chunk c's
// state update, and splitting M's work evenly between the warpgroups.
//
// Numerics (bf16): C, B and x arrive in bf16, so their products are
// exact in f32.  Three operands are f32: M, the carried state and x w.
// Rounding any of them to bf16 once breaks the check's tolerance
// (2 bf16 ulps of y, 1e-4 of max |state|; tests/test_torch_ssd_design.py
// models this kernel's rounding on the CPU), so each is split into
// hi = bf16(v) and lo = bf16(v - hi), both products summed into one f32
// accumulator (about 16 bits of v).  dt A is rounded before the scan;
// the scan: lane l of warp 0 sums rows 4 l .. 4 l + 3 in order, a
// Hillis-Steele scan over the 32 lane totals (shuffles), then each row
// adds its lane's exclusive prefix.  The decay and w take e^x as ex2.approx
// of x log2 e (x <= 0; relative error about |x| 2^-24 + 2^-22, where the
// value is not negligible far below M's bf16 lo term); exp(L) and
// exp(L_Q), which scale y and the whole state, are expf (no fast math).
// exp is evaluated only where the mask keeps it (above the diagonal
// L_t - L_j reaches hundreds: exp would be inf, and inf * 0 NaN).
//
// f32: ssd_scan_tf32_kernel, 3xTF32 on the tensor cores.  A tf32 product
// keeps 10 mantissa bits and misses the 1e-4 check by over 10x; each f32
// operand v is split into hi (the raw word: the tensor cores read an f32
// word's top 19 bits, tf32 by truncation) and lo = v - trunc(v), and hi
// hi' + hi lo' + lo hi' go into one f32 accumulator (CUTLASS's "fast
// f32"; tests/test_torch_tf32_design.py models it, each wgmma's sum
// truncated: it holds the check's cases, one tf32 product does not).
// wgmma takes tf32 only K-major, so every operand the bf16 kernel reads
// MN-major is transposed in the pass that writes its lo term.  f32 tiles
// are twice bf16's: a 128-row chunk with its lo and transposed copies
// needs over 400 KB, so the kernel takes steps of 64 rows (exact steps
// of the recurrence, the rounding differs at f32 level), one stage: x, B
// and C (80 KB by TMA,
// 128-byte swizzle, rows past S as zeros) plus 128 KB of terms it writes
// (213 KB, one block an SM).  Per step, two warpgroups:
//   all:  C lo and B lo beside their tiles; x^T hi and lo (rows p);
//   W0:   G = C B^T (m64n64k8, K = N = 128, 48 products) into registers,
//         then M = G * decay * dt (mask first: exp only where j <= t),
//         written as M hi and lo (rows t);
//   W1:   y^T = state C^T (rows p, columns t: K = N runs over the state,
//         whose accumulator registers are the A operand, 48 products),
//         scaled by exp(L_t) per column, then y^T += x^T M^T (24);
//   all:  (w B)^T hi and lo (rows n, w folded into B, so x^T serves both
//         products) over C lo and B lo;
//   W1:   state = exp(L_Q) state + x^T (w B) (m64n128k8, 24), and y = y^T
//         + D x stored (f32, rows t < S) while it runs.
// W1 holds the (P, N) = (64, 128) state as one m64n128 accumulator.  Fed
// as an A operand, an accumulator's 8-column block holds its K values in
// the order 0 2 4 6 1 3 5 7 (hopper.cuh), so (w B)^T's rows are written
// in that order: accumulator column c holds state column tf32_k_slot(c),
// and the A operand reads the state in natural K order, matching C's
// tile.  The next step's x, C and B load as soon as each is copied out or
// read (after x^T, after G and C state^T, after (w B)^T); warp 0 runs the
// next step's scan of dt A (2 rows a lane, then a Hillis-Steele scan over
// the lane totals) while W1 updates the state.  The decay and w take e^x
// as ex2.approx of x log2 e (relative error about 2^-22); exp(L) and
// exp(L_Q), which scale y and the whole state, are expf (no fast math).
// Bound at the prefill's call (B 4, S 500): 2.72 GFLOP at 495 / 3 TFLOP/s
// (tf32, three products) = 0.0165 ms; 40.1 MB at 3.35 TB/s = 0.0120 ms.
// The kernel takes about 4.2x that: a step is a chain of four phases
// behind barriers.  G's C from registers (half its shared-memory reads)
// and skipping the zero state's products read no faster (PERF.md); the
// lever is overlapping step c + 1's G and M with step c's state update,
// which needs the shared memory one stage already fills.
//
// (P, N) = (64, 128) (mamba2-370m) and (64, 64) (zamba2-7b) are built.
// At N 64, B, C and the state are one 64-column panel (the f32 kernel:
// two 32-float panels, the state one m64n64 accumulator, (w B)^T's
// panels N rows deep).  In the bf16 kernel both warpgroups then hold the
// same state panel and update it alike, so no branch surrounds the
// products; warpgroup 0 alone writes it.  zamba2-7b's prefill (B 4, S
// 500, H 112, Q 128) is 5.67 GFLOP (5.7 us at the bf16 peak) against
// 66 MB of bf16 inputs and outputs (20 us): bytes; 448 blocks, one an
// SM, about 3.4 waves.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxChunk = 128;   // Q a chunk may take (the bf16 tile)

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 128;              // rows of a chunk tile (Q <= 128)
constexpr int kThreads = 256;           // two consumer warpgroups
constexpr int kPanel = kRows * 128;     // a 128-row tile of 128-byte rows
constexpr int kHalf = 64 * 128;         // a 64-row tile

template <int P, int N>
struct Smem {
  static_assert(P == 64, "one 128-byte swizzle row holds 64 bf16 of x");
  static_assert(N == 64 || N == 128, "one or two 64-column panels of B, C "
                "and the state, one state panel a warpgroup (m64n64)");
  static constexpr int kNP = N / 64;                  // panels of B, C
  static constexpr int kX = 0;                        // in a stage
  static constexpr int kB = kPanel;
  static constexpr int kC = kB + kNP * kPanel;
  static constexpr int kStage = kC + kNP * kPanel;    // 80 KB
  static constexpr int kStHi = 2 * kStage;            // kNP 64-row panels
  static constexpr int kStLo = kStHi + kNP * kHalf;
  static constexpr int kXwHi = kStLo + kNP * kHalf;
  static constexpr int kXwLo = kXwHi + kPanel;
  static constexpr int kL = kXwLo + kPanel;           // L, then dt
  static constexpr int kBars = kL + 2 * kRows * 4;
  static constexpr int kBytes = 1024 + kBars + 2 * 8; // alignment slack
};

// e^x as 2^(x log2 e) on the special-function unit (relative error about
// 2^-22 beside the rounding of x log2 e, |x| 2^-24 relative; results
// under 2^-126 flush to 0)
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// pack (a, b) as bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Warpgroup R's part of a chunk before the state update: y = exp(L) (C
// state^T) + M x into acc (rows 64 R .. 64 R + 63), and, in warpgroup 0
// (which builds half as much of M), the x w tiles.  wtid: the thread's
// index in its warpgroup; kNP: the state's 64-column panels (N / 64).
template <int R, int kNP>
__device__ __forceinline__ void chunk_y(
    float (&acc)[32], const unsigned char* sx, const unsigned char* sb,
    const unsigned char* sc, const unsigned char* st_hi,
    const unsigned char* st_lo, unsigned char* xw_hi, unsigned char* xw_lo,
    const float* Ls, const float* dts, int Q, int wtid) {
  constexpr int kG = 32 * (R + 1);      // G: m64n64 (R 0), m64n128 (R 1)
  constexpr int kK = 4 * (R + 1);       // 16-wide K steps of M x
  const int warp = wtid >> 5, lane = wtid & 31;
  float g[kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) g[i] = 0.f;
  hopper::fence_regs(g);
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  // K-major operands: rows of 128 bytes, 8-row atoms 1024 apart; a
  // 16-wide K step is 32 bytes (+2); K = N runs over the panels
#pragma unroll
  for (int kk = 0; kk < 4 * kNP; ++kk) {
    const uint64_t da = hopper::desc_sw128(
        sc + (kk >> 2) * kPanel + R * kHalf, 16, 1024) + 2 * (kk & 3);
    const uint64_t db = hopper::desc_sw128(sb + (kk >> 2) * kPanel, 16,
                                           1024) + 2 * (kk & 3);
    if constexpr (R == 0)
      hopper::wgmma_m64n64k16_ss(g, da, db, kk);
    else
      hopper::wgmma_m64n128k16_ss(g, da, db, kk);
  }
  hopper::wgmma_commit();
  // C state^T once G is done, so that it runs while M is built (issued
  // together, the second group's issue waits on the first's products)
  hopper::wgmma_wait<0>();
  hopper::fence_regs(g);
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const unsigned char* st = part ? st_lo : st_hi;
#pragma unroll
    for (int kk = 0; kk < 4 * kNP; ++kk) {
      const uint64_t da = hopper::desc_sw128(
          sc + (kk >> 2) * kPanel + R * kHalf, 16, 1024) + 2 * (kk & 3);
      const uint64_t ds = hopper::desc_sw128(st + (kk >> 2) * kHalf, 16,
                                             1024) + 2 * (kk & 3);
      hopper::wgmma_m64n64k16_ss(acc, da, ds, part | kk);
    }
  }
  hopper::wgmma_commit();

  // M = G * decay * dt at row t, column j of the accumulator (hopper.cuh)
  const int r0 = 64 * R + 16 * warp + (lane >> 2);
  const float Lr[2] = {Ls[r0], Ls[r0 + 8]};
  // kept: j <= t and j < Q
  const int jmax[2] = {min(r0, Q - 1), min(r0 + 8, Q - 1)};
#pragma unroll
  for (int jb = 0; jb < kG / 4; ++jb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * jb + 2 * (lane & 3) + e;
      const float Lj = Ls[j], dj = dts[j];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& m = g[4 * jb + 2 * r + e];
        // decide the mask first: exp only at or below the diagonal
        m = j <= jmax[r] ? m * exp_approx(Lr[r] - Lj) * dj : 0.f;
      }
    }
  uint32_t mh[kG / 2], ml[kG / 2];
#pragma unroll
  for (int i = 0; i < kG / 2; ++i) split2(g[2 * i], g[2 * i + 1], mh[i],
                                          ml[i]);

  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  const float eL[2] = {expf(Lr[0]), expf(Lr[1])};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= eL[(i >> 1) & 1];
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  // x is N-major (rows j of 64 p): a 16-row K step is +2048 bytes (+128)
  const uint64_t dx = hopper::desc_sw128(sx, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    hopper::wgmma_m64n64k16_rs_tb(acc, mh[4 * kk], mh[4 * kk + 1],
                                  mh[4 * kk + 2], mh[4 * kk + 3],
                                  dx + 128 * kk);
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    hopper::wgmma_m64n64k16_rs_tb(acc, ml[4 * kk], ml[4 * kk + 1],
                                  ml[4 * kk + 2], ml[4 * kk + 3],
                                  dx + 128 * kk);
  hopper::wgmma_commit();

  // x w = x * exp(L_Q - L_t) dt_t, hi and lo, in x's own (swizzled)
  // layout: a 16-byte chunk of the tile holds 8 values of one row;
  // warpgroup 0 writes all 128 rows while the M x products run
  if constexpr (R == 0) {
    const float LQ = Ls[Q - 1];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = wtid + 128 * i;     // chunk of the tile
      const int t = k >> 3;
      const int off = t * 128 + (k & 7) * 16;
      const float w = exp_approx(LQ - Ls[t]) * dts[t];
      const uint4 raw = *reinterpret_cast<const uint4*>(sx + off);
      const uint32_t* xv = reinterpret_cast<const uint32_t*>(&raw);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xv[q]));
        split2(f.x * w, f.y * w, hi[q], lo[q]);
      }
      *reinterpret_cast<uint4*>(xw_hi + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(xw_lo + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  // the register A operands stay live until the products are done
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x,   // (b, S, H, P) bf16
    const __grid_constant__ CUtensorMap tm_b,   // (b, S, N) bf16
    const __grid_constant__ CUtensorMap tm_c,
    const float* __restrict__ dt,               // (b, S, H)
    const float* __restrict__ A,                // (H,)
    const float* __restrict__ D,                // (H,)
    __nv_bfloat16* __restrict__ y,              // (b, S, H, P)
    float* __restrict__ fin,                    // (b, H, P, N)
    int S, int H, int Q) {
  using L = Smem<P, N>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t pad = (1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* st_hi = base + L::kStHi;
  unsigned char* st_lo = base + L::kStLo;
  unsigned char* xw_hi = base + L::kXwHi;
  unsigned char* xw_lo = base + L::kXwLo;
  float* Ls = reinterpret_cast<float*>(base + L::kL);
  float* dts = Ls + kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);

  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  // warp-uniform as the compiler sees it (a shuffle): the branches on it
  // hold wgmma, which ptxas serialises in a path it thinks divergent
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const float a = A[h], d = D[h];
  // S need not be a multiple of Q: rows past S load as zeros (TMA) or
  // dt = 0, which leave y and the state exact, and are not stored
  const int n_chunks = (S + Q - 1) / Q;

  auto load_chunk = [&](int c) {       // one thread: chunk c's tiles
    unsigned char* st = base + (c & 1) * L::kStage;
    uint64_t* bar = &full[c & 1];
    const int t0 = c * Q;
    hopper::mbar_expect_tx(bar, L::kStage);
    hopper::tma_load_4d(st + L::kX, &tm_x, bar, 0, h, t0, bi);
#pragma unroll
    for (int k = 0; k < L::kNP; ++k) {
      hopper::tma_load_3d(st + L::kB + k * kPanel, &tm_b, bar, 64 * k, t0,
                          bi);
      hopper::tma_load_3d(st + L::kC + k * kPanel, &tm_c, bar, 64 * k, t0,
                          bi);
    }
  };
  float dtv[4];                        // warp 0: rows 4 lane + k
  auto load_dt = [&](int c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * lane + k;
      dtv[k] = t < Q && c * Q + t < S
                   ? dt[((size_t)bi * S + c * Q + t) * H + h] : 0.f;
    }
  };
  auto scan = [&]() {                  // warp 0: L of dtv's chunk
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(dtv[k], a);
#pragma unroll
    for (int k = 1; k < 4; ++k) v[k] = __fadd_rn(v[k - 1], v[k]);
    float tot = v[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, tot, o);
      if (lane >= o) tot = __fadd_rn(tot, u);
    }
    float ex = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane == 0) ex = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Ls[4 * lane + k] = __fadd_rn(ex, v[k]);
      dts[4 * lane + k] = dtv[k];
    }
  };

  // the state starts at zero
  for (int i = tid; i < 2 * L::kNP * kHalf / 16; i += kThreads)
    reinterpret_cast<uint4*>(st_hi)[i] = make_uint4(0u, 0u, 0u, 0u);
  hopper::fence_proxy_async();
  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::fence_barrier_init();
    load_chunk(0);
  }
  if (tid < 32) {
    load_dt(0);
    scan();
    if (n_chunks > 1) load_dt(1);
  }
  __syncthreads();

  // state[p][64 pw + n], m64n64: at N 128 each warpgroup holds its own
  // panel; at N 64 both hold the one panel and update it alike (no branch
  // around the products), and warpgroup 0 alone writes it
  const int pw = wg % L::kNP;
  float st[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const unsigned char* sx = base + (c & 1) * L::kStage + L::kX;
    const unsigned char* sb = base + (c & 1) * L::kStage + L::kB;
    const unsigned char* sc = base + (c & 1) * L::kStage + L::kC;
    // the stage of chunk c + 1 was last read in chunk c - 1; L and dt
    // of chunk c were written before the last barrier
    if (tid == 0 && c + 1 < n_chunks) load_chunk(c + 1);
    hopper::mbar_wait(&full[c & 1], (c >> 1) & 1);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (wg == 0)
      chunk_y<0, L::kNP>(acc, sx, sb, sc, st_hi, st_lo, xw_hi, xw_lo, Ls,
                         dts, Q, wtid);
    else
      chunk_y<1, L::kNP>(acc, sx, sb, sc, st_hi, st_lo, xw_hi, xw_lo, Ls,
                         dts, Q, wtid);
    const float eLQ = expf(Ls[Q - 1]);
    hopper::fence_proxy_async();
    // x w written, both warpgroups done reading the state, L and
    // dt (warp 0 writes the next chunk's below)
    __syncthreads();

    // state = exp(L_Q) state + (x w)^T B over this warpgroup's columns:
    // x w is M-major (transposed A), B N-major, a 16-row K step +128
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] *= eLQ;
    hopper::fence_regs(st);
    hopper::wgmma_fence();
    const uint64_t dbn = hopper::desc_sw128(sb + pw * kPanel, 1024, 1024);
    const uint64_t dwh = hopper::desc_sw128(xw_hi, 1024, 1024);
    const uint64_t dwl = hopper::desc_sw128(xw_lo, 1024, 1024);
    const int kq = (Q + 15) / 16;      // rows past them are zero
    for (int kk = 0; kk < kq; ++kk)
      hopper::wgmma_m64n64k16_ss<1, 1>(st, dwh + 128 * kk, dbn + 128 * kk,
                                       1);
    for (int kk = 0; kk < kq; ++kk)
      hopper::wgmma_m64n64k16_ss<1, 1>(st, dwl + 128 * kk, dbn + 128 * kk,
                                       1);
    hopper::wgmma_commit();

    // y = acc + D x in bf16, staged in this warpgroup's 64 rows of the
    // stage's first C panel (C is read: G and C state^T are done), in
    // the 128-byte swizzle (row t's 16-byte chunk jb at jb ^ (t % 8), as
    // in x's tile), then stored a 16-byte chunk a thread, rows t < Q
    unsigned char* ys = base + (c & 1) * L::kStage + L::kC + wg * kHalf;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tl = 16 * warp + (lane >> 2) + 8 * r, t = 64 * wg + tl;
#pragma unroll
      for (int jb = 0; jb < P / 8; ++jb) {
        const int off = ((jb ^ (tl & 7)) << 4) + 4 * (lane & 3);
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sx + t * 128 + off));
        *reinterpret_cast<__nv_bfloat162*>(ys + tl * 128 + off) =
            __floats2bfloat162_rn(acc[4 * jb + 2 * r] + d * xf.x,
                                  acc[4 * jb + 2 * r + 1] + d * xf.y);
      }
    }
    hopper::named_barrier(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = wtid + 128 * i, tl = k >> 3, t = 64 * wg + tl;
      if (t < Q && c * Q + t < S)
        *reinterpret_cast<uint4*>(
            y + (((size_t)bi * S + c * Q + t) * H + h) * P + 8 * (k & 7)) =
            *reinterpret_cast<const uint4*>(
                ys + tl * 128 + (((k & 7) ^ (tl & 7)) << 4));
    }
    if (tid < 32 && c + 1 < n_chunks) {
      scan();                          // L and dt of chunk c + 1
      if (c + 2 < n_chunks) load_dt(c + 2);
    }

    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    // the state's hi and lo terms for the next chunk's C state^T: row p,
    // column n of this warpgroup's panel, 128-byte swizzle
    if (wg < L::kNP) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * warp + (lane >> 2) + 8 * r;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int off = pw * kHalf + p * 128 + ((jb ^ (p & 7)) << 4)
                          + 4 * (lane & 3);
          uint32_t hi, lo;
          split2(st[4 * jb + 2 * r], st[4 * jb + 2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(st_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(st_lo + off) = lo;
        }
      }
    }
    hopper::fence_proxy_async();
    // the stage and x w are free; the state and the next L are written
    __syncthreads();
  }

  if (wg >= L::kNP) return;
  float* fp = fin + ((size_t)bi * H + h) * P * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 16 * warp + (lane >> 2) + 8 * r;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
      *reinterpret_cast<float2*>(fp + p * N + 64 * pw + 8 * jb
                                 + 2 * (lane & 3)) =
          make_float2(st[4 * jb + 2 * r], st[4 * jb + 2 * r + 1]);
  }
}

// a contiguous bf16 tensor as a tensor map (hopper.cuh): dims innermost
// first, boxes of 64 innermost elements and 128 rows
bool tensor_map(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  cuuint64_t strides[hopper::kMaxRank - 1];
  cuuint64_t bytes = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  return hopper::bf16_tensor_map(map, ptr, rank, dims, strides, box);
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, void* y, float* fin, int b,
           int S, int H, int Q, cudaStream_t stream) {
  const cuuint64_t xd[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                            (cuuint64_t)b};
  const cuuint32_t xbox[4] = {64, 1, kRows, 1};
  const cuuint64_t bd[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)b};
  const cuuint32_t bbox[3] = {64, kRows, 1};
  CUtensorMap tx, tb, tcm;
  if (!tensor_map(&tx, x, 4, xd, xbox) || !tensor_map(&tb, B, 3, bd, bbox)
      || !tensor_map(&tcm, C, 3, bd, bbox))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<P, N>::kBytes;
  auto kern = ssd_scan_wgmma_kernel<P, N>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, b), kThreads, smem, stream>>>(
      tx, tb, tcm, dt, A, D, static_cast<__nv_bfloat16*>(y), fin, S, H, Q);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: tensor cores, 3xTF32 (wgmma), TMA
// ---------------------------------------------------------------------------

namespace tf {

constexpr int kRows = 64;               // rows a step
constexpr int kThreads = 256;           // two warpgroups
constexpr int kPanel = kRows * 128;     // 64 rows of 128 bytes (32 f32)

template <int P, int N>
struct Smem {
  static_assert(P == 64, "x: two 32-float panels, x^T one m64 operand");
  static_assert(N == 64 || N == 128, "B, C: N / 32 32-float panels; the "
                "state one m64nN accumulator");
  static constexpr int kNP = N / 32;                 // panels of B, C
  static constexpr int kWB = N * 128;                // (w B)^T: 32 j, N rows
  // the TMA tiles (rows t), used as the hi terms as they land
  static constexpr int kX = 0;                       // 2 panels
  static constexpr int kB = kX + 2 * kPanel;         // kNP panels
  static constexpr int kC = kB + kNP * kPanel;       // kNP panels
  // C lo and B lo (C's and B's layout), then (w B)^T hi and lo (N rows n,
  // 2 panels of 32 j each)
  static constexpr int kCL = kC + kNP * kPanel;
  static constexpr int kBL = kCL + kNP * kPanel;
  static_assert(2 * kWB == kNP * kPanel, "(w B)^T fills C lo's place");
  static constexpr int kXT = kBL + kNP * kPanel;     // x^T hi, lo (rows p)
  static constexpr int kMT = kXT + 4 * kPanel;       // M hi, lo (rows t)
  static constexpr int kArr = kMT + 4 * kPanel;      // L, dt, exp(L), w
  static constexpr int kBars = kArr + 4 * kRows * 4;
  static constexpr int kBytes = 1024 + kBars + 3 * 8; // alignment slack
};

using tc::exp_approx;

// K step kk's descriptor of a tile of this kernel's panels
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int kk,
                                          int panel = kPanel) {
  return hopper::desc_tf32_k(tile, kk, panel);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_x,   // (b, S, H, P) f32
    const __grid_constant__ CUtensorMap tm_b,   // (b, S, N) f32
    const __grid_constant__ CUtensorMap tm_c,
    const float* __restrict__ dt,               // (b, S, H)
    const float* __restrict__ A,                // (H,)
    const float* __restrict__ D,                // (H,)
    float* __restrict__ y,                      // (b, S, H, P)
    float* __restrict__ fin,                    // (b, H, P, N)
    int S, int H) {
  using L = Smem<P, N>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t pad = (1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* sx = base + L::kX;
  unsigned char* sb = base + L::kB;
  unsigned char* sc = base + L::kC;
  unsigned char* scl = base + L::kCL;        // then (w B)^T hi
  unsigned char* sbl = base + L::kBL;        // then (w B)^T lo
  unsigned char* sxt = base + L::kXT;        // lo at + 2 panels
  unsigned char* smt = base + L::kMT;        // lo at + 2 panels
  float* Ls = reinterpret_cast<float*>(base + L::kArr);
  float* dts = Ls + kRows;
  float* eLs = dts + kRows;
  float* ws = eLs + kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);  // x B C

  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  // warp-uniform as the compiler sees it (a shuffle): the branches on it
  // hold wgmma, which ptxas serialises in a path it thinks divergent
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const float a = A[h], d = D[h];
  const int n_steps = (S + kRows - 1) / kRows;

  // one thread: step c's tiles, each behind its own barrier
  auto load_x = [&](int c) {
    hopper::mbar_expect_tx(&full[0], 2 * kPanel);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      hopper::tma_load_4d(sx + k * kPanel, &tm_x, &full[0], 32 * k, h,
                          c * kRows, bi);
  };
  auto load_bc = [&](unsigned char* dst, const CUtensorMap* map,
                     uint64_t* bar, int c) {
    hopper::mbar_expect_tx(bar, L::kNP * kPanel);
#pragma unroll
    for (int k = 0; k < L::kNP; ++k)
      hopper::tma_load_3d(dst + k * kPanel, map, bar, 32 * k, c * kRows, bi);
  };
  float dtv[2];                        // warp 0: rows 2 lane + k
  auto load_dt = [&](int c) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = c * kRows + 2 * lane + k;
      dtv[k] = t < S ? dt[((size_t)bi * S + t) * H + h] : 0.f;
    }
  };
  auto scan = [&]() {                  // warp 0: L, exp(L), w of dtv's step
    const float v0 = __fmul_rn(dtv[0], a);
    const float v1 = __fadd_rn(v0, __fmul_rn(dtv[1], a));
    float tot = v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, tot, o);
      if (lane >= o) tot = __fadd_rn(tot, u);
    }
    float ex = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane == 0) ex = 0.f;
    const float L0 = __fadd_rn(ex, v0), L1 = __fadd_rn(ex, v1);
    const float LQ = __shfl_sync(0xffffffffu, L1, 31);
    Ls[2 * lane] = L0;
    Ls[2 * lane + 1] = L1;
    dts[2 * lane] = dtv[0];
    dts[2 * lane + 1] = dtv[1];
    eLs[2 * lane] = expf(L0);
    eLs[2 * lane + 1] = expf(L1);
    ws[2 * lane] = exp_approx(LQ - L0) * dtv[0];
    ws[2 * lane + 1] = exp_approx(LQ - L1) * dtv[1];
  };

  if (tid == 0) {
    for (int k = 0; k < 3; ++k) hopper::mbar_init(&full[k], 1);
    hopper::fence_barrier_init();
    load_x(0);
    load_bc(sb, &tm_b, &full[1], 0);
    load_bc(sc, &tm_c, &full[2], 0);
  }
  if (tid < 32) {
    load_dt(0);
    scan();
    if (n_steps > 1) load_dt(1);
  }
  __syncthreads();

  // W1: state[p][tf32_k_slot(c)] at row p, column c of an m64nN
  // accumulator (hopper.cuh)
  float st[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st[i] = 0.f;
  const int r0 = 16 * warp + (lane >> 2);   // accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);            // columns 8 j + c0 + {0, 1}

  for (int c = 0; c < n_steps; ++c) {
    const uint32_t par = c & 1;
    hopper::mbar_wait(&full[0], par);
    hopper::mbar_wait(&full[1], par);
    hopper::mbar_wait(&full[2], par);

    // C lo and B lo, in place of their tiles' layout
    for (int i = tid; i < L::kNP * kPanel / 16; i += kThreads) {
      reinterpret_cast<float4*>(scl)[i] =
          hopper::tf32_lo4(reinterpret_cast<const float4*>(sc)[i]);
      reinterpret_cast<float4*>(sbl)[i] =
          hopper::tf32_lo4(reinterpret_cast<const float4*>(sb)[i]);
    }
    // x^T hi (the raw word) and lo: row p, element t; a warp reads 32
    // rows t of one 4-column chunk and writes 32 consecutive elements
    for (int i = tid; i < kRows * P / 4; i += kThreads) {
      const int t = i & (kRows - 1), p = (i / kRows) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          sx + (p >> 5) * kPanel + hopper::sw128_f32(t, p & 31));
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (t >> 5) * kPanel + hopper::sw128_f32(p + e, t & 31);
        *reinterpret_cast<float*>(sxt + off) = xv[e];
        *reinterpret_cast<float*>(sxt + 2 * kPanel + off) =
            hopper::tf32_lo(xv[e]);
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();                   // x is copied out: load the next
    if (tid == 0 && c + 1 < n_steps) load_x(c + 1);

    float acc[32];                     // W0: G, M (rows t, columns j);
#pragma unroll                         // W1: y^T (rows p, columns t)
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float eLQ = 0.f;
    if (wg == 0) {
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) {
        const uint64_t dc = kdesc(sc, kk), db = kdesc(sb, kk);
        hopper::wgmma_m64n64k8_tf32_ss(acc, dc, db, kk);
        hopper::wgmma_m64n64k8_tf32_ss(acc, dc, kdesc(sbl, kk), 1);
        hopper::wgmma_m64n64k8_tf32_ss(acc, kdesc(scl, kk), db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      // M = G * decay * dt; then M hi (raw) and lo at row t, element j
      const float Lr[2] = {Ls[r0], Ls[r0 + 8]};
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * jb + c0 + e;
          const float Lj = Ls[j], dj = dts[j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& m = acc[4 * jb + 2 * r + e];
            // decide the mask first: exp only at or below the diagonal
            m = j <= r0 + 8 * r ? m * exp_approx(Lr[r] - Lj) * dj : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 8 * jb + c0;
          const int off = (j >> 5) * kPanel
                          + hopper::sw128_f32(r0 + 8 * r, j & 31);
          const float m0 = acc[4 * jb + 2 * r], m1 = acc[4 * jb + 2 * r + 1];
          *reinterpret_cast<float2*>(smt + off) = make_float2(m0, m1);
          *reinterpret_cast<float2*>(smt + 2 * kPanel + off) =
              make_float2(hopper::tf32_lo(m0), hopper::tf32_lo(m1));
        }
      }
    } else {
      // y^T = state C^T: the state's registers are the A operand (hi the
      // raw words, lo written here), K order permuted (hopper.cuh)
      float sl[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sl[i] = hopper::tf32_lo(st[i]);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) {
        const uint64_t dc = kdesc(sc, kk);
        hopper::wgmma_m64n64k8_tf32_rs(acc, st[4 * kk], st[4 * kk + 2],
                                       st[4 * kk + 1], st[4 * kk + 3], dc);
        hopper::wgmma_m64n64k8_tf32_rs(acc, st[4 * kk], st[4 * kk + 2],
                                       st[4 * kk + 1], st[4 * kk + 3],
                                       kdesc(scl, kk));
        hopper::wgmma_m64n64k8_tf32_rs(acc, sl[4 * kk], sl[4 * kk + 2],
                                       sl[4 * kk + 1], sl[4 * kk + 3], dc);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(st);
      // scale column t by exp(L_t)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = eLs[8 * jb + c0 + e];
          acc[4 * jb + e] *= f;
          acc[4 * jb + 2 + e] *= f;
        }
      eLQ = eLs[kRows - 1];
    }
    hopper::fence_proxy_async();
    __syncthreads();                   // M written; C, C lo, B lo read
    if (tid == 0 && c + 1 < n_steps) load_bc(sc, &tm_c, &full[2], c + 1);

    if (wg == 1) {                     // y^T += x^T M^T
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk) {
        const uint64_t dx = kdesc(sxt, kk), dm = kdesc(smt, kk);
        hopper::wgmma_m64n64k8_tf32_ss(acc, dx, dm, 1);
        hopper::wgmma_m64n64k8_tf32_ss(acc, dx, kdesc(smt + 2 * kPanel, kk),
                                       1);
        hopper::wgmma_m64n64k8_tf32_ss(acc, kdesc(sxt + 2 * kPanel, kk), dm,
                                       1);
      }
      hopper::wgmma_commit();
      // awaited here: a product in flight across the barrier and the
      // branches below makes ptxas serialise every wgmma (C7518)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    // (w B)^T hi and lo over C lo and B lo: row tf32_k_col(n) (the state's
    // column order), element j; a warp reads 32 rows j of one 4-column
    // chunk of B and writes 32 consecutive elements
    for (int i = tid; i < kRows * N / 4; i += kThreads) {
      const int j = i & (kRows - 1), n = (i / kRows) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          sb + (n >> 5) * kPanel + hopper::sw128_f32(j, n & 31));
      const float w = ws[j];
      const float bv[4] = {v.x * w, v.y * w, v.z * w, v.w * w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (j >> 5) * L::kWB
                        + hopper::sw128_f32(hopper::tf32_k_col(n + e),
                                            j & 31);
        *reinterpret_cast<float*>(scl + off) = bv[e];
        *reinterpret_cast<float*>(sbl + off) = hopper::tf32_lo(bv[e]);
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();                   // (w B)^T written; B, L, w read
    if (tid == 0 && c + 1 < n_steps) load_bc(sb, &tm_b, &full[1], c + 1);
    if (tid < 32 && c + 1 < n_steps) {
      scan();                          // L, exp(L), w of step c + 1
      if (c + 2 < n_steps) load_dt(c + 2);
    }

    if (wg == 1) {
      // state = exp(L_Q) state + x^T (w B)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) st[i] *= eLQ;
      hopper::fence_regs(st);
      hopper::wgmma_fence();
      auto prod = [&](uint64_t da, uint64_t db) {
        if constexpr (N == 128)
          hopper::wgmma_m64n128k8_tf32_ss(st, da, db, 1);
        else
          hopper::wgmma_m64n64k8_tf32_ss(st, da, db, 1);
      };
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk) {
        const uint64_t dx = kdesc(sxt, kk);
        const uint64_t dw = kdesc(scl, kk, L::kWB);
        prod(dx, dw);
        prod(dx, kdesc(sbl, kk, L::kWB));
        prod(kdesc(sxt + 2 * kPanel, kk), dw);
      }
      hopper::wgmma_commit();
      // meanwhile y = y^T + D x (x^T hi is x), rows t < S: a warp's store
      // covers 8 consecutive p of 4 rows t
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * jb + c0 + e;
          if (c * kRows + t >= S) continue;
          float* yp = y + (((size_t)bi * S + c * kRows + t) * H + h) * P;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = r0 + 8 * r;
            const float xv = *reinterpret_cast<const float*>(
                sxt + (t >> 5) * kPanel + hopper::sw128_f32(p, t & 31));
            yp[p] = acc[4 * jb + 2 * r + e] + d * xv;
          }
        }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
    }
    __syncthreads();                   // x^T, M, (w B)^T read; next L
  }

  if (wg == 1) {
    float* fp = fin + ((size_t)bi * H + h) * P * N;
#pragma unroll
    for (int jb = 0; jb < N / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fp[(r0 + 8 * (e >> 1)) * N
           + hopper::tf32_k_slot(8 * jb + c0 + (e & 1))] = st[4 * jb + e];
  }
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, void* y, float* fin, int b,
           int S, int H, cudaStream_t stream) {
  const cuuint64_t xd[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                            (cuuint64_t)b};
  const cuuint64_t xs[3] = {(cuuint64_t)P * 4, (cuuint64_t)H * P * 4,
                            (cuuint64_t)S * H * P * 4};
  const cuuint32_t xbox[4] = {32, 1, kRows, 1};
  const cuuint64_t bd[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)b};
  const cuuint64_t bs[2] = {(cuuint64_t)N * 4, (cuuint64_t)S * N * 4};
  const cuuint32_t bbox[3] = {32, kRows, 1};
  CUtensorMap tx, tb, tcm;
  if (!hopper::f32_tensor_map(&tx, x, 4, xd, xs, xbox)
      || !hopper::f32_tensor_map(&tb, B, 3, bd, bs, bbox)
      || !hopper::f32_tensor_map(&tcm, C, 3, bd, bs, bbox))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<P, N>::kBytes;
  auto kern = ssd_scan_tf32_kernel<P, N>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, b), kThreads, smem, stream>>>(
      tx, tb, tcm, dt, A, D, static_cast<float*>(y), fin, S, H);
  return (int)cudaGetLastError();
}

}  // namespace tf

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               void* y, void* fin, int b, int S, int H,
                               int P, int N, int Q, int bf16, void* stream) {
  // any S >= Q: both kernels mask the ragged end
  if (Q < 1 || Q > kMaxChunk || S < Q) return (int)cudaErrorInvalidValue;
  if (b == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* ff = static_cast<float*>(fin);
  // built for the (P, N) the configurations run on the card:
  // mamba2-370m's (64, 128) and zamba2-7b's (64, 64)
  if (P == 64 && N == 128)
    return bf16 ? tc::launch<64, 128>(x, dtf, Af, B, C, Df, y, ff, b, S, H,
                                      Q, s)
                : tf::launch<64, 128>(x, dtf, Af, B, C, Df, y, ff, b, S, H,
                                      s);
  if (P == 64 && N == 64)
    return bf16 ? tc::launch<64, 64>(x, dtf, Af, B, C, Df, y, ff, b, S, H,
                                     Q, s)
                : tf::launch<64, 64>(x, dtf, Af, B, C, Df, y, ff, b, S, H, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
