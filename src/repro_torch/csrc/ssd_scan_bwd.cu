// The gradient of Mamba2's SSD scan (csrc/ssd_scan.cu).  In: x (b, S, H,
// P), B and C (b, S, N) (one group) and dy (b, S, H, P) in f32 or bf16
// (one dtype); dt (b, S, H), A and D (H,) in f32; the final state's
// gradient (b, H, P, N) in f32, or none (zeros).  Out: dx (b, S, H, P),
// dB and dC (b, S, N) in the inputs' dtype; ddt (b, S, H), dA and dD (H,)
// in f32.  Rows past S get no gradient (and read as dt = 0).
//
// Replaces no TPU kernel: the JAX package has no Pallas backward, and
// differentiates the scan's plain chunked form (_chunked_jnp,
// src/repro/kernels/ssd_scan/ops.py) with jax.grad.  This is the port's
// gradient of src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas.
//
// The math, per (row b, head h), by steps of 64 rows (any chunking gives
// the same gradient up to rounding, so the forward's Q does not matter),
// in reverse.  With s = dt A, L = cumsum(s) inside the step (L <= 0), S-
// the state entering the step and dS the gradient of the state leaving
// it (from the final state's gradient, carried back):
//   dx_j  = D dy_j + dt_j sum_{t>=j} (C_t.B_j) e^{L_t-L_j} dy_t
//           + e^{L_Q-L_j} dt_j dS B_j
//   dB_j  = sum_{t>=j} e^{L_t-L_j} dt_j (dy_t.x_j) C_t
//           + e^{L_Q-L_j} dt_j dS^T x_j                 (summed over heads)
//   dC_t  = sum_{j<=t} e^{L_t-L_j} dt_j (dy_t.x_j) B_j
//           + e^{L_t} S-^T dy_t                         (summed over heads)
//   ddt_j = sum_{t>=j} (C_t.B_j) e^{L_t-L_j} (dy_t.x_j)
//           + e^{L_Q-L_j} x_j^T dS B_j + A ds_j,  dA = sum_j dt_j ds_j,
//   dD    = sum_t dy_t.x_t,
//   dS   <- e^{L_Q} dS + sum_t e^{L_t} dy_t C_t^T,
// where ds_k sums every term whose exponent spans step k: the pairs j <
// k <= t of v_tj = (C_t.B_j) e^{L_t-L_j} dt_j (dy_t.x_j), e^{L_t} dy_t.S-
// C_t for t >= k, e^{L_Q} <dS, S->, and e^{L_Q-L_j} dt_j x_j^T dS B_j for
// j < k.  The pairs are summed directly (a row's exclusive prefix over j,
// then a column's sum over t >= k), not as a per-row dL followed by a
// reverse cumsum, whose large terms cancel.  The exp of L_t - L_j is
// taken only for j <= t: above the diagonal it can overflow (and an inf
// times a zero is NaN).
//
// Three kernels a call, no atomics (two calls give the same bits):
//   ssd_scan_bwd_states_kernel: one block per (head, row), the steps in
//     order, the state update alone in f32 registers, writing the state
//     entering each step to scratch (b, steps, H, P, N) f32 (the forward
//     kernel stays as it is and writes no states);
//   ssd_scan_bwd_kernel: one block per (head, row), the steps in reverse,
//     dS in shared memory in f32; the step's x, dy, B, C and S- land in
//     shared memory as f32 (every product in f32 FMAs on the CUDA cores,
//     whatever the input dtype), the pair matrices (C B^T decayed, the
//     decayed dy x^T times dt, and their product) beside them; each
//     product is a 64-row tile, 256 threads each owning 4 rows and every
//     16th column (row strides odd: no bank conflicts either way round);
//     dx and ddt are written directly, dB and dC as per-head f32
//     partials (b, S, H, N), dA and dD as per-row partials (b, H);
//   ssd_scan_bwd_sum_kernel: the partials summed in head (and row)
//     order, in f32, rounded once.
// Shared memory (f32, N 128): x, dy 16.3 KB each, B, C, dS, S- 33 KB each,
// three 64 x 65 pair matrices 49.9 KB, vectors 2.6 KB: 217,920 bytes, one
// block an SM.
//
// Bound on an H100, at the mamba2-370m train step's call (B 4, S 1024, H
// 32, P 64, N 128, bf16): per (row, head, step of R = 64 rows) the pair
// terms take R (R + 1) (2 P + 2 N) flops (dy x^T, dx's pairs, dB's and
// dC's pairs, half of each R x R product) and the state terms 10 R P N
// (dS B, dS^T x, S-^T dy, dS's update and the forward's state update,
// recomputed), plus C B^T once a (row, step): 14.0 GFLOP, 0.0142 ms at
// the bf16 tensor-core peak; 55.6 MB of inputs and outputs, 0.0166 ms at
// 3.35 TB/s, the bound.  This first kernel runs f32 FMAs on the CUDA
// cores (67 TFLOP/s: 0.21 ms at best) with the steps of a (row, head) in sequence,
// 128 blocks on 132 SMs; tensor cores and the chunk-parallel form are
// later work.
//
// The launcher's `plant` argument is 0 in every real call (the public
// wrapper passes 0).  The card's check sets it to plant a fault and shows the check catches it: 1 drops
// the dS carried from one step to the one before, 2 sums dB over head 0
// only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 64;            // rows a step
constexpr int kP = 64;            // head dim
constexpr int kThreads = 256;     // 16 row groups of 4 x 16 column lanes
constexpr int kPlantDropCarry = 1;
constexpr int kPlantOneHead = 2;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// acc[i][c] += sum_{k < K} a(k, r0 + i) * b(k, c0 + 16 c) for i < 4, c <
// NC / 16, with r0 = 4 (tid / 16) and c0 = tid % 16: a 64 x NC tile of
// outputs over 256 threads.  In a warp, a() reads two rows (broadcast to
// 16 lanes each) and b() 16 consecutive columns: conflict-free when a
// column index runs along a row, or down a column of odd row stride.
template <int NC, int K, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[4][NC / 16], FA a, FB b) {
  const int r0 = 4 * (threadIdx.x >> 4), c0 = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NC / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a(k, r0 + i);
#pragma unroll
    for (int c = 0; c < NC / 16; ++c) bv[c] = b(k, c0 + 16 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC / 16; ++c)
        acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC / 16; ++c) acc[i][c] = 0.f;
}

// the sum of v over the 16 lanes that share a row group (a butterfly:
// the same order every call)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// x and dy rows t0 .. t0 + 63 of head h, and B (and C) rows, into shared
// memory as f32 at odd row strides; rows past S as zeros
template <typename T>
__device__ __forceinline__ void load_rows(const T* src, float* dst, int b,
                                          int t0, int S, int H, int h) {
  for (int i = threadIdx.x; i < kR * kP; i += kThreads) {
    const int t = i / kP, p = i % kP, row = t0 + t;
    dst[t * (kP + 1) + p] =
        row < S ? ld(src, (((size_t)b * S + row) * H + h) * kP + p) : 0.f;
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_group(const T* src, float* dst, int b,
                                           int t0, int S) {
  for (int i = threadIdx.x; i < kR * N; i += kThreads) {
    const int t = i / N, n = i % N, row = t0 + t;
    dst[t * (N + 1) + n] =
        row < S ? ld(src, ((size_t)b * S + row) * N + n) : 0.f;
  }
}

// dts[t] = dt of row t0 + t (0 past S), then, by thread 0 in row order,
// Ls[t] = sum_{j <= t} dt_j A: the same steps in both kernels
__device__ __forceinline__ void load_dt(const float* dt, float* dts,
                                       int b, int t0, int S, int H, int h) {
  if (threadIdx.x < kR) {
    const int row = t0 + threadIdx.x;
    dts[threadIdx.x] = row < S ? dt[((size_t)b * S + row) * H + h] : 0.f;
  }
}

__device__ __forceinline__ void scan_L(const float* dts, float* Ls,
                                       float a) {
  if (threadIdx.x == 0) {
    float L = 0.f;
    for (int j = 0; j < kR; ++j) {
      L += dts[j] * a;
      Ls[j] = L;
    }
  }
}

template <int N>
struct StatesSmem {
  static constexpr int kX = 0;                       // [kR][kP + 1], x w
  static constexpr int kB = kX + kR * (kP + 1);      // [kR][N + 1]
  static constexpr int kDt = kB + kR * (N + 1);
  static constexpr int kL = kDt + kR;
  static constexpr int kBytes = (kL + kR) * 4;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_bwd_states_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ B,
    float* __restrict__ states, int S, int H) {
  using L = StatesSmem<N>;
  extern __shared__ float sm[];
  float* xs = sm + L::kX;
  float* bs = sm + L::kB;
  float* dts = sm + L::kDt;
  float* Ls = sm + L::kL;
  const int h = blockIdx.x, b = blockIdx.y;
  const int steps = (S + kR - 1) / kR;
  const float a = A[h];
  const int r0 = 4 * (threadIdx.x >> 4), c0 = threadIdx.x & 15;
  float state[4][N / 16];
  zero<N>(state);
  for (int c = 0; c < steps; ++c) {
    float* out = states + (((size_t)b * steps + c) * H + h) * (kP * N);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j)
        out[(r0 + i) * N + c0 + 16 * j] = state[i][j];
    if (c == steps - 1) break;
    const int t0 = c * kR;
    __syncthreads();               // the last step's reads are done
    load_rows<T>(x, xs, b, t0, S, H, h);
    load_group<T, N>(B, bs, b, t0, S);
    load_dt(dt, dts, b, t0, S, H, h);
    __syncthreads();
    scan_L(dts, Ls, a);
    __syncthreads();
    const float LQ = Ls[kR - 1];
    // x_t w_t, w_t = e^{L_Q - L_t} dt_t
    for (int i = threadIdx.x; i < kR * kP; i += kThreads) {
      const int t = i / kP, p = i % kP;
      xs[t * (kP + 1) + p] *= expf(LQ - Ls[t]) * dts[t];
    }
    __syncthreads();
    float acc[4][N / 16];
    zero<N>(acc);
    mm<N, kR>(acc, [&](int k, int r) { return xs[k * (kP + 1) + r]; },
              [&](int k, int col) { return bs[k * (N + 1) + col]; });
    const float decay = expf(LQ);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j)
        state[i][j] = fmaf(decay, state[i][j], acc[i][j]);
  }
}

template <int N>
struct Smem {
  static constexpr int kSP = kP + 1;   // odd row strides
  static constexpr int kSN = N + 1;
  static constexpr int kSR = kR + 1;
  static constexpr int kX = 0;
  static constexpr int kDy = kX + kR * kSP;
  static constexpr int kB = kDy + kR * kSP;
  static constexpr int kC = kB + kR * kSN;
  static constexpr int kDS = kC + kR * kSN;     // [kP][kSN]
  static constexpr int kSm = kDS + kP * kSN;    // [kP][kSN]
  static constexpr int kMg = kSm + kP * kSN;    // [t][j]: (C.B) e^{L_t-L_j}
  static constexpr int kW = kMg + kR * kSR;     // e^{L_t-L_j} dt_j (dy.x)
  static constexpr int kZ = kW + kR * kSR;      // Mg (dy.x)
  static constexpr int kVec = kZ + kR * kSR;
  // vectors of kR: dt, L, e^L, e^{L_Q-L}, r, u, zsum, dy.x, dt ds
  static constexpr int kDt = kVec, kL = kDt + kR, kEL = kL + kR,
                       kTail = kEL + kR, kRv = kTail + kR, kU = kRv + kR,
                       kZsum = kU + kR, kDd = kZsum + kR, kDsdt = kDd + kR,
                       kRed = kDsdt + kR;       // 8 warps' partials + 1
  static constexpr int kBytes = (kRed + 16) * 4;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ C, const float* __restrict__ D,
    const T* __restrict__ dy, const float* __restrict__ dfin,
    const float* __restrict__ states, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ dAp,
    float* __restrict__ dDp, int S, int H, int plant) {
  using L = Smem<N>;
  constexpr int SP = L::kSP, SN = L::kSN, SR = L::kSR;
  extern __shared__ float sm[];
  float* xs = sm + L::kX;
  float* dys = sm + L::kDy;
  float* bs = sm + L::kB;
  float* cs = sm + L::kC;
  float* dSs = sm + L::kDS;
  float* sms = sm + L::kSm;
  float* Mg = sm + L::kMg;
  float* Ws = sm + L::kW;
  float* Zs = sm + L::kZ;
  float* dts = sm + L::kDt;
  float* Ls = sm + L::kL;
  float* eLs = sm + L::kEL;
  float* tails = sm + L::kTail;
  float* rs = sm + L::kRv;
  float* us = sm + L::kU;
  float* zsum = sm + L::kZsum;
  float* dds = sm + L::kDd;
  float* dsdt = sm + L::kDsdt;
  float* red = sm + L::kRed;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = 4 * (tid >> 4), c0 = tid & 15;
  const int steps = (S + kR - 1) / kR;
  const float a = A[h], dcoef = D[h];
  for (int i = tid; i < kP * N; i += kThreads)
    dSs[(i / N) * SN + i % N] =
        dfin ? dfin[((size_t)b * H + h) * (kP * N) + i] : 0.f;
  float dA_blk = 0.f, dD_blk = 0.f;     // thread 0's
  for (int c = steps - 1; c >= 0; --c) {
    const int t0 = c * kR;
    __syncthreads();               // dS's init or the last step is done
    load_rows<T>(x, xs, b, t0, S, H, h);
    load_rows<T>(dy, dys, b, t0, S, H, h);
    load_group<T, N>(B, bs, b, t0, S);
    load_group<T, N>(C, cs, b, t0, S);
    const float* sg = states + (((size_t)b * steps + c) * H + h) * (kP * N);
    for (int i = tid; i < kP * N; i += kThreads)
      sms[(i / N) * SN + i % N] = sg[i];
    load_dt(dt, dts, b, t0, S, H, h);
    __syncthreads();
    scan_L(dts, Ls, a);
    // <dS, S->, block-reduced in a fixed order
    float part = 0.f;
    for (int i = tid; i < kP * N; i += kThreads) {
      const int o = (i / N) * SN + i % N;
      part = fmaf(dSs[o], sms[o], part);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, m);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    const float LQ = Ls[kR - 1];
    if (tid < kR) {
      eLs[tid] = expf(Ls[tid]);
      tails[tid] = expf(LQ - Ls[tid]);
      float s = 0.f;
      for (int p = 0; p < kP; ++p)
        s = fmaf(dys[tid * SP + p], xs[tid * SP + p], s);
      dds[tid] = s;
    }
    if (tid == kThreads - 1) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w];
      red[8] = s;
    }
    // the pairs (t, j): G = C_t.B_j and E = dy_t.x_j, masked before exp
    {
      float g[4][4], e[4][4];
      zero<64>(g);
      zero<64>(e);
      mm<64, N>(g, [&](int k, int r) { return cs[r * SN + k]; },
                [&](int k, int col) { return bs[col * SN + k]; });
      mm<64, kP>(e, [&](int k, int r) { return dys[r * SP + k]; },
                 [&](int k, int col) { return xs[col * SP + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = r0 + i, j = c0 + 16 * jj;
          float mg = 0.f, w = 0.f, z = 0.f;
          if (j <= t) {
            const float seg = expf(Ls[t] - Ls[j]);
            mg = g[i][jj] * seg;
            w = seg * dts[j] * e[i][jj];
            z = mg * e[i][jj];
          }
          Mg[t * SR + j] = mg;
          Ws[t * SR + j] = w;
          Zs[t * SR + j] = z;
        }
    }
    __syncthreads();
    if (tid == 0) {
      for (int t = 0; t < kR; ++t) dD_blk += dds[t];
    }
    // dx (rows j, columns p) and r_j = x_j^T dS B_j
    {
      float a1[4][4], a2[4][4];
      zero<64>(a1);
      zero<64>(a2);
      mm<64, kR>(a1, [&](int k, int r) { return Mg[k * SR + r]; },
                 [&](int k, int col) { return dys[k * SP + col]; });
      mm<64, N>(a2, [&](int k, int r) { return bs[r * SN + k]; },
                [&](int k, int col) { return dSs[col * SN + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = r0 + i, row = t0 + j;
        float rj = 0.f;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const int p = c0 + 16 * pp;
          rj = fmaf(xs[j * SP + p], a2[i][pp], rj);
          const float v = fmaf(dcoef, dys[j * SP + p],
                               dts[j] * fmaf(tails[j], a2[i][pp], a1[i][pp]));
          if (row < S) st(dx, (((size_t)b * S + row) * H + h) * kP + p, v);
        }
        rj = sum16(rj);
        if (c0 == 0) rs[j] = rj;
      }
    }
    if (tid < kR) {                // ddt's pairs: the column sum of Z
      float s = 0.f;
      for (int t = tid; t < kR; ++t) s += Zs[t * SR + tid];
      zsum[tid] = s;
    }
    // dB (rows j, columns n), as this head's partial
    {
      float a1[4][N / 16], a2[4][N / 16];
      zero<N>(a1);
      zero<N>(a2);
      mm<N, kR>(a1, [&](int k, int r) { return Ws[k * SR + r]; },
                [&](int k, int col) { return cs[k * SN + col]; });
      mm<N, kP>(a2, [&](int k, int r) { return xs[r * SP + k]; },
                [&](int k, int col) { return dSs[k * SN + col]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = r0 + i, row = t0 + j;
        if (row >= S) continue;
        const float f = tails[j] * dts[j];
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn)
          dBh[(((size_t)b * S + row) * H + h) * N + c0 + 16 * nn] =
              fmaf(f, a2[i][nn], a1[i][nn]);
      }
    }
    // dC (rows t, columns n), as this head's partial, and u_t =
    // e^{L_t} dy_t.S- C_t
    {
      float a1[4][N / 16], a2[4][N / 16];
      zero<N>(a1);
      zero<N>(a2);
      mm<N, kR>(a1, [&](int k, int r) { return Ws[r * SR + k]; },
                [&](int k, int col) { return bs[k * SN + col]; });
      mm<N, kP>(a2, [&](int k, int r) { return dys[r * SP + k]; },
                [&](int k, int col) { return sms[k * SN + col]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + i, row = t0 + t;
        float ut = 0.f;
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {
          const int n = c0 + 16 * nn;
          ut = fmaf(a2[i][nn], cs[t * SN + n], ut);
          if (row < S)
            dCh[(((size_t)b * S + row) * H + h) * N + n] =
                fmaf(eLs[t], a2[i][nn], a1[i][nn]);
        }
        ut = sum16(ut);
        if (c0 == 0) us[t] = eLs[t] * ut;
      }
    }
    __syncthreads();
    // row t of V = dt_j Z_tj becomes its exclusive prefix over j
    if (tid < kR) {
      float run = 0.f;
      for (int j = 0; j < kR; ++j) {
        const float v = dts[j] * Zs[tid * SR + j];
        Zs[tid * SR + j] = run;
        run += v;
      }
    }
    __syncthreads();
    // ds_k, ddt_k and dt_k ds_k (k = tid)
    if (tid < kR) {
      const int k = tid;
      float pairs = 0.f, su = 0.f, sw = 0.f;
      for (int t = k; t < kR; ++t) {
        pairs += Zs[t * SR + k];
        su += us[t];
      }
      for (int j = 0; j < k; ++j) sw += tails[j] * dts[j] * rs[j];
      const float ds = pairs + su + sw + expf(LQ) * red[8];
      if (t0 + k < S)
        ddt[((size_t)b * S + t0 + k) * H + h] =
            zsum[k] + tails[k] * rs[k] + a * ds;
      dsdt[k] = dts[k] * ds;
    }
    // dS <- e^{L_Q} dS + sum_t e^{L_t} dy_t C_t^T (rows p, columns n);
    // every read of dS this step is behind the barriers above
    {
      float acc[4][N / 16];
      zero<N>(acc);
      mm<N, kR>(acc, [&](int k, int r) { return eLs[k] * dys[k * SP + r]; },
                [&](int k, int col) { return cs[k * SN + col]; });
      const float eQ = plant == kPlantDropCarry ? 0.f : expf(LQ);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {
          float& d = dSs[(r0 + i) * SN + c0 + 16 * nn];
          d = fmaf(eQ, d, acc[i][nn]);
        }
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < kR; ++k) dA_blk += dsdt[k];
    }
  }
  if (tid == 0) {
    dAp[(size_t)b * H + h] = dA_blk;
    dDp[(size_t)b * H + h] = dD_blk;
  }
}

// dB and dC: the per-head partials summed in head order (a thread an
// element); dA and dD: the per-row partials in row order
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_bwd_sum_kernel(
    const float* __restrict__ dBh, const float* __restrict__ dCh,
    const float* __restrict__ dAp, const float* __restrict__ dDp,
    T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
    float* __restrict__ dD, int b, int S, int H, int N, int plant) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < (size_t)b * S * N) {
    const size_t base = (i / N) * H * N + i % N;
    const int hb = plant == kPlantOneHead ? 1 : H;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < hb; ++h) sb += dBh[base + (size_t)h * N];
    for (int h = 0; h < H; ++h) sc += dCh[base + (size_t)h * N];
    st(dB, i, sb);
    st(dC, i, sc);
  }
  if (i < (size_t)H) {
    float sa = 0.f, sd = 0.f;
    for (int r = 0; r < b; ++r) {
      sa += dAp[(size_t)r * H + i];
      sd += dDp[(size_t)r * H + i];
    }
    dA[i] = sa;
    dD[i] = sd;
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, const void* dy, const float* dfin,
           void* dx, float* ddt, float* dA, void* dB, void* dC, float* dD,
           float* states, float* dBh, float* dCh, float* dAp, float* dDp,
           int b, int S, int H, int plant, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const T* dyt = static_cast<const T*>(dy);
  auto ks = ssd_scan_bwd_states_kernel<T, N>;
  auto kb = ssd_scan_bwd_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      ks, cudaFuncAttributeMaxDynamicSharedMemorySize, StatesSmem<N>::kBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<N>::kBytes);
  if (err != cudaSuccess) return (int)err;
  ks<<<dim3(H, b), kThreads, StatesSmem<N>::kBytes, stream>>>(
      xt, dt, A, Bt, states, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3(H, b), kThreads, Smem<N>::kBytes, stream>>>(
      xt, dt, A, Bt, Ct, D, dyt, dfin, states, static_cast<T*>(dx), ddt,
      dBh, dCh, dAp, dDp, S, H, plant);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)b * S * N > (size_t)H ? (size_t)b * S * N
                                                   : (size_t)H;
  ssd_scan_bwd_sum_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(
      dBh, dCh, dAp, dDp, static_cast<T*>(dB), static_cast<T*>(dC), dA, dD,
      b, S, H, N, plant);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int N, const void* x, const float* dt, const float* A,
             const void* B, const void* C, const float* D, const void* dy,
             const float* dfin, void* dx, float* ddt, float* dA, void* dB,
             void* dC, float* dD, float* states, float* dBh, float* dCh,
             float* dAp, float* dDp, int b, int S, int H, int plant,
             cudaStream_t s) {
  if (N == 128)
    return launch<T, 128>(x, dt, A, B, C, D, dy, dfin, dx, ddt, dA, dB, dC,
                          dD, states, dBh, dCh, dAp, dDp, b, S, H, plant, s);
  if (N == 64)
    return launch<T, 64>(x, dt, A, B, C, D, dy, dfin, dx, ddt, dA, dB, dC,
                         dD, states, dBh, dCh, dAp, dDp, b, S, H, plant, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// scratch (the wrapper allocates it): states (b, ceil(S / 64), H, P, N),
// dBh and dCh (b, S, H, N), dAp and dDp (b, H), all f32
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* dy, const void* dfin,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
    void* states, void* dBh, void* dCh, void* dAp, void* dDp, int b, int S,
    int H, int P, int N, int bf16, int plant, void* stream) {
  if (P != kP || (N != 64 && N != 128) || S < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* df = static_cast<const float*>(dfin);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* dDf = static_cast<float*>(dD);
  float* stf = static_cast<float*>(states);
  float* dBhf = static_cast<float*>(dBh);
  float* dChf = static_cast<float*>(dCh);
  float* dApf = static_cast<float*>(dAp);
  float* dDpf = static_cast<float*>(dDp);
  return bf16 ? dispatch<__nv_bfloat16>(N, x, dtf, Af, B, C, Df, dy, df, dx,
                                        ddtf, dAf, dB, dC, dDf, stf, dBhf,
                                        dChf, dApf, dDpf, b, S, H, plant, s)
              : dispatch<float>(N, x, dtf, Af, B, C, Df, dy, df, dx, ddtf,
                                dAf, dB, dC, dDf, stf, dBhf, dChf, dApf,
                                dDpf, b, S, H, plant, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
