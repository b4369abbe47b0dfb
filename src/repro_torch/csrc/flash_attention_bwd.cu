// The gradient of flash attention: dQ, dK and dV of
//   O = softmax(sm_scale * Q K^T + mask) V
// for q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), the forward's output o
// (B, Sq, Hq, D) and its gradient do, all f32 or all bf16; dq, dk and dv
// come out in the same dtype, every sum in f32.  The masks are the
// forward's (csrc/flash_attention.cu): queries at the END of the key
// axis when Sq < Skv (query i at position Skv - Sq + i), keys at or past
// n_valid masked, a query row that sees no key gives 0 (and zero
// gradients); GQA reads KV head h / (Hq / Hkv) for query head h.
//
// Replaces no TPU kernel: the JAX package differentiates its Pallas
// forward (src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas) on the TPU, and its memory-bounded _chunked_jnp
// elsewhere, by JAX's autodiff; it has no backward kernel and no
// custom_vjp.  The port's forward is a kernel on the card whose output
// has no autograd graph, so training needs this one.
//
// Bound on an H100: the train step of qwen2-0.5b (B 1 a microbatch, S
// 4096, Hq 14, Hkv 2, D 64, causal, bf16) moves q, o, do and dq (7.3 MB
// each) and k, v, dk and dv (1.0 MB each), 33.6 MB (10 us at 3.35 TB/s),
// and needs 4 products of 2 D flops for each of the 14 * 8.39 M visible
// (query, key) pairs plus the recomputed Q K^T, 10 D flops a pair (2.5
// times the forward's 4 D): 75 GFLOP, 76 us at the 989 TFLOP/s bf16
// tensor-core peak, so operations bound it.
//
// Two instances, one per dtype; flash_attention_bwd_launch dispatches on
// bf16, and a bf16 call never runs the f32 kernels.
//
// bf16 (namespace tc): three kernels on tensor cores (wgmma, operands
// fed by TMA), no atomics, so two calls on the same inputs give the same
// bits.  They do 22 D flops a visible pair, not the bound's 10 D: Q K^T
// three times (twice in the first kernel, once in the second), dP twice,
// and the three second products twice each (P and dS as bf16 hi + lo,
// below).
//
// Kernel A (flash_attention_bwd_dq_wgmma_kernel): one block per (64-row
// query tile, q head, batch row), last tiles first (they see the most
// keys), as the forward: one consumer warpgroup and one producer warp.
// Q and dO stay in shared memory; K and V tiles of 64 keys pass through a
// TMA ring of kStages stages (full / empty mbarriers) over the forward's
// 4-D tensor maps (d, head, position, batch), only K in the first pass.
// The consumers take Di = rowsum(dO * O) in f32 from global memory (two
// threads a row).  Pass 1: S = Q K^T (wgmma m64n64k16, both operands
// K-major from shared memory), scaled by sm_scale * log2(e) after the
// product; each row's max and sum of ex2.approx over its visible keys,
// as the forward's online softmax, so lse2 = m + log2(l) is in log2
// units (+inf for a row with no visible key).  lse2 and Di go to the
// (B, Hq, Sqp) f32 scratch (Sqp = Sq rounded up to 64; rows past Sq get
// +inf and 0).  Pass 2: S and dP = dO V^T on wgmma, P = ex2(S c - lse2)
// and dS = P (dP - Di) in registers, then dQ += dS K with dS as the A
// operand straight from the accumulator's registers and K MN-major from
// the stage, one m64n64 accumulator per 64-column panel of D.  dQ =
// sm_scale * acc, stored masked by row.
//
// Kernel B (flash_attention_bwd_dkdv_wgmma_kernel): one block per
// (64-key tile, QUERY head, batch row), numbered so that key tile 0's
// blocks (the longest chains in causal attention) start first.  With
// the work split by query head the train call has 896 blocks (not 128
// for its two KV heads), and the longest chain is 64 query tiles (not 7
// heads x 64 = 448).  K and V of the tile stay in shared memory; Q and dO
// tiles of the block's head pass through the TMA ring, each with its 64
// rows' lse2 and Di by a 1-D bulk copy.  S^T = K Q^T and dP^T = V dO^T on
// wgmma (K-major both sides), P^T and dS^T in registers, then dV += P^T
// dO and dK += dS^T Q (dO and Q MN-major).  Query tiles wholly before
// the key tile (causal) are never loaded.  With G = Hq / Hkv > 1 a block
// writes its head's f32 partial dK and dV into the (B, Skv, Hq, D)
// scratch pair the wrapper allocates, and kernel C
// (flash_attention_bwd_sum_kernel) sums each KV head's G partials in head
// order and writes dk (times sm_scale) and dv; with G = 1 kernel B scales
// and writes them itself and kernel C is not launched.  At the train
// call the scratch is 2 x 14.7 MB (about 18 us of traffic).
//
// Both kernels skip tiles wholly above the causal diagonal or past
// n_valid and the mask on tiles wholly inside it, as the forward; a
// masked pair's p is exactly 0.  D 112 is two 64-column panels, the
// second zero-filled past D by TMA (flash_attention.cu); D 128 two whole
// panels.  Shared memory: A and B each hold two resident tiles and two
// stages of two, 49 KB at D 64 and 97 KB at D 112 and 128 (kernel B 1 KB
// more for lse2 and Di).
//
// Numerics (bf16): products of bf16 are exact in f32, and each wgmma
// truncates its f32 sum.  P and dS enter the second products as bf16 hi =
// bf16(x) and lo = bf16(x - hi), both into the same accumulator, so they
// carry about 16 bits: rounded once, they moved dq, dk and dv by
// 0.0010-0.0031 of max |plain| in the CPU model of this design
// (tests/test_torch_bwd_design.py), up to 40% of the check's near-zero
// band, where hi + lo moves them by under 1e-5.  ex2.approx adds about
// 2^-22 to each p.  Di reads the forward's output in bf16.
//
// Registers (nvcc 12.9, -Xptxas -v; no spill, no stack frame, no wgmma
// serialised): kernel A 124 / 161 / 161 at D 64 / 112 / 128, kernel B 168
// / 241 / 251 (dK and dV hold 2 x 64 f32 a thread at D 128, S^T and dP^T
// 64 more), kernel C 40.  At the train call (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md) the three take 0.199, 0.205 and 0.008 device ms,
// 0.412 in all against the 0.076 bound (5.4x) and SDPA's backward's 0.269.
// Not tried yet: the forward writing lse (it would save pass 1), two
// consumer warpgroups a block, a persistent grid.
//
// f32 (namespace cc): the first design, unchanged: two kernels on CUDA
// cores, f32 FMAs out of shared memory (flash_attention_bwd_dq_kernel,
// one block of 256 threads per query tile, head and row, as kernel A;
// flash_attention_bwd_dkdv_kernel, one block per key tile, KV head and
// row, walking the group's query heads and summing them inside the
// block).  Tiles are 64 x 64; thread (ty, tx) of the 16 x 16 grid owns
// rows ty + 16 i and columns tx + 16 j (i, j < 4) of a score tile, and
// rows ty + 16 i and head-dim columns tx + 16 j (j < D / 16) of an
// accumulator.  Rows of a tile lie in shared memory with a stride of D +
// 1 floats (odd), so the 16 columns a warp reads at one d fall in 16
// banks.  It reads lse and Di at a row stride of Sq in the scratch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

namespace cc {

constexpr int kT = 64;          // query rows and keys a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kSP = kT + 1;     // stride of a 64 x 64 score tile

template <int D>
struct Smem {
  static constexpr int kRow = D + 1;           // row stride of a D tile
  static constexpr int kTile = kT * kRow;      // floats in a D tile
  // kernel A: Q, dO, K, V and dS
  static constexpr int kA = (4 * kTile + kT * kSP) * 4;
  // kernel B: K, V, Q, dO, P^T, dS^T, lse, Di
  static constexpr int kB = (4 * kTile + 2 * kT * kSP + 2 * kT) * 4;
};

// rows [r0, r0 + 64) of one head of a (B, S, H, D) tensor into a tile of
// stride D + 1 as f32; rows at or past S are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          int r0, int S, int H) {
  using L = attn::Ld<T>;
  constexpr int kChunks = D / L::N;
  for (int idx = threadIdx.x; idx < kT * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    float vals[L::N];
    if (r0 + r < S) {
      L::load(base + (size_t)(r0 + r) * H * D + c * L::N, vals);
    } else {
#pragma unroll
      for (int e = 0; e < L::N; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < L::N; ++e)
      tile[r * (D + 1) + c * L::N + e] = vals[e];
  }
}

// acc[i][j] = sum_d a[(ty + 16 i), d] * b[(tx + 16 j), d] over two tiles
// of stride D + 1
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c s[(ty + 16 i), c] * m[c, (tx + 16 j)]: a 64 x 64
// score tile (stride 65) times a D tile (stride D + 1)
template <int D>
__device__ __forceinline__ void accumulate(const float* s, const float* m,
                                           int ty, int tx,
                                           float acc[4][D / 16]) {
#pragma unroll 4
  for (int c = 0; c < kT; ++c) {
    float x[4], y[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = s[(ty + 16 * i) * kSP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = m[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool visible(int key, int qpos, int n_valid,
                                        int causal) {
  return key < n_valid && (!causal || key <= qpos);
}

// the keys query rows [q0, q0 + 64) may see: [0, end)
__device__ __forceinline__ int key_end(int q0, int Sq, int Skv, int n_valid,
                                       int causal) {
  int end = n_valid;
  if (causal) end = min(end, min(q0 + kT, Sq) + Skv - Sq);
  return max(end, 0);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ o,
                              const T* __restrict__ dout, T* __restrict__ dq,
                              float* __restrict__ lse_out,
                              float* __restrict__ di_out, int Sq, int Skv,
                              int Hq, int Hkv, int n_valid, int causal,
                              float scale) {
  extern __shared__ float smem[];
  using Sm = Smem<D>;
  float* qs = smem;
  float* dos = qs + Sm::kTile;
  float* ks = dos + Sm::kTile;
  float* vs = ks + Sm::kTile;
  float* ds = vs + Sm::kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kT, shift = Skv - Sq;
  const T* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const T* ob = o + ((size_t)b * Sq * Hq + h) * D;
  const T* dob = dout + ((size_t)b * Sq * Hq + h) * D;
  const T* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  load_tile<T, D>(qs, qb, q0, Sq, Hq);
  load_tile<T, D>(dos, dob, q0, Sq, Hq);
  __syncthreads();

  // Di = rowsum(dO * O), a row over its 16 threads
  float di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    if (q0 + r < Sq) {
      const T* orow = ob + (size_t)(q0 + r) * Hq * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        part = fmaf(dos[r * (D + 1) + tx + 16 * j],
                    attn::to_f32(orow[tx + 16 * j]), part);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    di[i] = part;
  }

  // pass 1: each row's max and sum of exp over its visible keys
  const int kend = key_end(q0, Sq, Skv, n_valid, causal);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, Skv, Hkv);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + shift;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (visible(k0 + tx + 16 * j, qpos, n_valid, causal))
          tmax = fmaxf(tmax, s[i][j]);
      }
      if (tmax > -INFINITY) {
        const float mn = fmaxf(m[i], tmax);
        float acc = l[i] * expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (visible(k0 + tx + 16 * j, qpos, n_valid, causal))
            acc += expf(s[i][j] - mn);
        m[i] = mn;
        l[i] = acc;
      }
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      if (mn > -INFINITY) {
        l[i] = l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
        m[i] = mn;
      }
    }
    // no visible key: lse = +inf, so every p below is exp(-inf) = 0
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < Sq) {
      const size_t at = ((size_t)b * Hq + h) * Sq + row;
      lse_out[at] = lse[i];
      di_out[at] = di[i];
    }
  }

  // pass 2: dQ = scale * sum_k P (dP - Di) K
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, Skv, Hkv);
    load_tile<T, D>(vs, vb, k0, Skv, Hkv);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(qs, ks, ty, tx, s);
    dot_tile<D>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + shift;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = visible(k0 + tx + 16 * j, qpos, n_valid, causal);
        const float p = vis ? expf(s[i][j] * scale - lse[i]) : 0.f;
        ds[(ty + 16 * i) * kSP + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    }
    __syncthreads();
    accumulate<D>(ds, ks, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = dq + (((size_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[tx + 16 * j] = attn::from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse_in,
                                const float* __restrict__ di_in,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int Sq, int Skv, int Hq, int Hkv, int n_valid,
                                int causal, float scale) {
  extern __shared__ float smem[];
  using Sm = Smem<D>;
  float* ks = smem;
  float* vs = ks + Sm::kTile;
  float* qs = vs + Sm::kTile;
  float* dos = qs + Sm::kTile;
  float* pt = dos + Sm::kTile;
  float* dst = pt + kT * kSP;
  float* lses = dst + kT * kSP;
  float* dis = lses + kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * kT, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, shift = Skv - Sq;
  const T* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  float adk[4][D / 16], adv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) adk[i][j] = adv[i][j] = 0.f;

  if (k0 < n_valid) {
    load_tile<T, D>(ks, kb, k0, Skv, Hkv);
    load_tile<T, D>(vs, vb, k0, Skv, Hkv);
    // the first query row that sees key k0 (causal), as a tile
    const int qstart = causal ? max(k0 - shift, 0) / kT * kT : 0;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const T* qb = q + ((size_t)b * Sq * Hq + h) * D;
      const T* dob = dout + ((size_t)b * Sq * Hq + h) * D;
      const size_t row0 = ((size_t)b * Hq + h) * Sq;
      for (int q0 = qstart; q0 < Sq; q0 += kT) {
        __syncthreads();
        load_tile<T, D>(qs, qb, q0, Sq, Hq);
        load_tile<T, D>(dos, dob, q0, Sq, Hq);
        if (tid < kT) {
          const bool in = q0 + tid < Sq;
          lses[tid] = in ? lse_in[row0 + q0 + tid] : INFINITY;
          dis[tid] = in ? di_in[row0 + q0 + tid] : 0.f;
        }
        __syncthreads();
        float s[4][4], dp[4][4];
        dot_tile<D>(ks, qs, ty, tx, s);      // S^T: keys x queries
        dot_tile<D>(vs, dos, ty, tx, dp);    // dP^T
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qr = tx + 16 * j;
            const bool vis = q0 + qr < Sq
                && visible(key, q0 + qr + shift, n_valid, causal);
            const float p = vis ? expf(s[i][j] * scale - lses[qr]) : 0.f;
            pt[(ty + 16 * i) * kSP + qr] = p;
            dst[(ty + 16 * i) * kSP + qr] = p * (dp[i][j] - dis[qr]);
          }
        }
        __syncthreads();
        accumulate<D>(pt, dos, ty, tx, adv);
        accumulate<D>(dst, qs, ty, tx, adk);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
    const size_t at = (((size_t)b * Skv + key) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[at + tx + 16 * j] = attn::from_f32<T>(adk[i][j] * scale);
      dv[at + tx + 16 * j] = attn::from_f32<T>(adv[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* di, int B, int Sq, int Skv, int Hq, int Hkv, int n_valid,
           int causal, float scale, cudaStream_t stream) {
  using Sm = Smem<D>;
  auto ka = flash_attention_bwd_dq_kernel<T, D>;
  auto kb = flash_attention_bwd_dkdv_kernel<T, D>;
  static const cudaError_t set_a = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kA);
  static const cudaError_t set_b = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kB);
  if (set_a != cudaSuccess) return (int)set_a;
  if (set_b != cudaSuccess) return (int)set_b;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (Sq > 0) {
    ka<<<dim3((Sq + kT - 1) / kT, Hq, B), kThreads, Sm::kA, stream>>>(
        tq, tk, tv, static_cast<const T*>(o), tdo, static_cast<T*>(dq), lse,
        di, Sq, Skv, Hq, Hkv, n_valid, causal, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Skv > 0)
    kb<<<dim3((Skv + kT - 1) / kT, Hkv, B), kThreads, Sm::kB, stream>>>(
        tq, tk, tv, tdo, lse, di, static_cast<T*>(dk), static_cast<T*>(dv),
        Sq, Skv, Hq, Hkv, n_valid, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv, float* lse,
                 float* di, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                 int n_valid, int causal, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, di, B, Sq, Skv,
                         Hq, Hkv, n_valid, causal, scale, stream);
  if (D == 112)
    return launch<T, 112>(q, k, v, o, dout, dq, dk, dv, lse, di, B, Sq, Skv,
                          Hq, Hkv, n_valid, causal, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, di, B, Sq, Skv,
                          Hq, Hkv, n_valid, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}
}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, a producer warp
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kT = 64;                        // query rows and keys a tile
constexpr int kStages = 2;                    // ring depth
constexpr int kConsumers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kSumThreads = 256;              // kernel C
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPanel = kT * 128;              // 64 rows of 64 bf16

// 2^x on the special-function unit (relative error about 2^-22; results
// under 2^-126 flush to 0, ex2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64-row tile of D columns is D / 64 panels of 64 columns (128-byte
// rows, the swizzle's width), the last filled with zeros past D by TMA.
// Both kernels hold two resident tiles and kStages stages of two tiles;
// kernel B also kStages rows of 64 lse2 and 64 Di.
template <int D>
struct Smem {
  static constexpr int kPanels = (D + 63) / 64;
  static constexpr int kTile = kPanels * kPanel;  // bytes of a 64-row tile
  static constexpr int kTiles = (2 + 2 * kStages) * kTile;
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static constexpr int kA = 1024 + kTiles + kT * 4 + kBars;
  static constexpr int kB = 1024 + kTiles + kStages * 2 * kT * 4 + kBars;
};

// K step kk (16 wide) of a K-major tile of 64-column panels: panel kk / 4,
// 32 bytes (+2) a step inside it (rows of 128 bytes, 8-row atoms 1024
// apart)
__device__ __forceinline__ uint64_t kdesc16(const unsigned char* tile,
                                            int kk) {
  return hopper::desc_sw128(tile + (kk >> 2) * kPanel, 16, 1024)
         + 2 * (kk & 3);
}

// acc = A B^T over d: A and B 64-row tiles, K-major (D / 16 steps; the
// first step overwrites acc)
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[32],
                                        const unsigned char* a,
                                        const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16_ss(acc, kdesc16(a, kk), kdesc16(b, kk), kk);
}

// acc[pn] += A B: A (64 x 64) bf16 from registers (the accumulator's
// layout, packed in pairs), B a 64-row tile read MN-major, one product
// per 64-column panel; a 16-row step is 16 rows of 128 bytes (+128)
template <int P>
__device__ __forceinline__ void mma_ab(float (&acc)[P][32],
                                       const uint32_t (&a)[16],
                                       const unsigned char* b) {
#pragma unroll
  for (int pn = 0; pn < P; ++pn) {
    const uint64_t db = hopper::desc_sw128(b + pn * kPanel, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      hopper::wgmma_m64n64k16_rs_tb(acc[pn], a[4 * kk], a[4 * kk + 1],
                                    a[4 * kk + 2], a[4 * kk + 3],
                                    db + 128 * kk);
  }
}

// x as bf16 hi = bf16(x) and lo = bf16(x - hi) (x - hi exact in f32),
// each packed in pairs as an A operand
__device__ __forceinline__ void split_pack(const float (&x)[32],
                                           uint32_t (&hi)[16],
                                           uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x[2 * i] - hf.x,
                                                   x[2 * i + 1] - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

template <int P>
__device__ __forceinline__ void fence_acc(float (&acc)[P][32]) {
#pragma unroll
  for (int pn = 0; pn < P; ++pn) hopper::fence_regs(acc[pn]);
}

template <int P>
__device__ __forceinline__ void zero_acc(float (&acc)[P][32]) {
#pragma unroll
  for (int pn = 0; pn < P; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
}

// stores row r (0 or 1: rows r0 and r0 + 8) of an m64nD accumulator times
// ``mul`` as bf16 (columns past D, zeros of the last panel, not stored)
template <int D, int P>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* out,
                                           const float (&acc)[P][32], int r,
                                           int c0, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c0) =
        __floats2bfloat162_rn(acc[j / 8][4 * (j % 8) + 2 * r] * mul,
                              acc[j / 8][4 * (j % 8) + 2 * r + 1] * mul);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // (B, Sq, Hq, D) bf16
    const __grid_constant__ CUtensorMap tm_k,   // (B, Skv, Hkv, D)
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,  // (B, Sq, Hq, D)
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ lse_out,
    float* __restrict__ di_out, int Sq, int Sqp, int Skv, int Hq, int Hkv,
    int n_valid, int causal, float scale, float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "wgmma takes K in steps of 16, "
                "dQ in at most two 64-column panels");
  using L = Smem<D>;
  constexpr int kTile = L::kTile;
  constexpr int kPanels = L::kPanels;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t pad = (1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* sQ = base;
  unsigned char* sDO = base + kTile;
  unsigned char* sK = base + 2 * kTile;                  // kStages tiles
  unsigned char* sV = base + (2 + kStages) * kTile;      // kStages tiles
  float* sDi = reinterpret_cast<float*>(base + L::kTiles);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kTiles + kT * 4);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                             // kStages
  uint64_t* empty = bars + 1 + kStages;                  // kStages

  const int qt = gridDim.z - 1 - blockIdx.z;             // longest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kT, shift = Skv - Sq;
  int kend = n_valid;                   // keys any row of the tile sees
  if (causal) kend = min(kend, min(q0 + kT, Sq) + shift);
  const int n_tiles = kend > 0 ? (kend + kT - 1) / kT : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // a lane of each consuming warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one lane issues every copy; pass 1 (tiles t < n_tiles)
    // takes K alone, pass 2 K and V
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, 2 * kTile);
      for (int p = 0; p < kPanels; ++p) {
        hopper::tma_load_4d(sQ + p * kPanel, &tm_q, q_full, 64 * p, h, q0, b);
        hopper::tma_load_4d(sDO + p * kPanel, &tm_do, q_full, 64 * p, h, q0,
                            b);
      }
      for (int t = 0; t < 2 * n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // the consumers are done with its last use
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        const bool both = t >= n_tiles;
        const int k0 = (both ? t - n_tiles : t) * kT;
        hopper::mbar_expect_tx(&full[s], (both ? 2 : 1) * kTile);
        for (int p = 0; p < kPanels; ++p) {
          hopper::tma_load_4d(sK + s * kTile + p * kPanel, &tm_k, &full[s],
                              64 * p, hk, k0, b);
          if (both)
            hopper::tma_load_4d(sV + s * kTile + p * kPanel, &tm_v,
                                &full[s], 64 * p, hk, k0, b);
        }
      }
    }
    return;
  }

  // consumers: thread (warp w, lane l) holds rows r0 and r0 + 8 of the
  // tile, columns 8 j + 2 (l % 4) + {0, 1} (hopper.cuh)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const size_t row0 = ((size_t)b * Hq + h) * Sqp + q0;   // scratch rows

  // Di = rowsum(dO * O) in f32, two threads a row (half of D each, 16
  // bytes a load); rows past Sq get 0
  {
    const int row = tid >> 1, half = tid & 1;
    float part = 0.f;
    if (q0 + row < Sq) {
      const size_t at = (((size_t)b * Sq + q0 + row) * Hq + h) * D
                        + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(o + at + c));
        const uint4 dv = __ldg(reinterpret_cast<const uint4*>(dout + at + c));
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(oh[e]);
          const float2 df = __bfloat1622float2(dh[e]);
          part = fmaf(df.x, of.x, part);
          part = fmaf(df.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      sDi[row] = part;
      di_out[row0 + row] = part;
    }
  }

  // pass 1: each row's max (log2 units) and this lane's share of its sum
  float m[2] = {attn::kNegInf, attn::kNegInf};
  float l[2] = {0.f, 0.f};
  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
    mma_abt<D>(sc, sQ, sK + s * kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);

    // mask (bit i of vis: sc[i] is visible; every key of a tile below
    // the diagonal and inside n_valid is) and scale; each row's max
    const int k0 = t * kT;
    uint32_t vis = 0xffffffffu;
    if (k0 + kT > n_valid || (causal && k0 + kT - 1 > q0 + shift)) {
      vis = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + (i >> 2) * 8 + c0 + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1) + shift;
        if (key < n_valid && (!causal || key <= qpos)) vis |= 1u << i;
      }
    }
    float mx[2] = {attn::kNegInf, attn::kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] *= scale_log2;
      if ((vis >> i) & 1u) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no visible key yet: m = m_new = kNegInf, alpha = 1 (l is 0)
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      if ((vis >> i) & 1u) ps[r] += ex2(sc[i] - m[r]);
    }
    l[0] = l[0] * alpha[0] + ps[0];
    l[1] = l[1] * alpha[1] + ps[1];
  }
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    // no visible key: lse2 = +inf, so every p below is ex2(-inf) = 0
    lse[r] = lt > 0.f ? m[r] + log2f(lt) : INFINITY;
    const int row = r0 + 8 * r;
    if ((lane & 3) == 0) lse_out[row0 + row] = q0 + row < Sq ? lse[r]
                                                             : INFINITY;
  }
  hopper::named_barrier(1, kConsumers);    // sDi written
  const float di[2] = {sDi[r0], sDi[r0 + 8]};

  // pass 2: dQ = scale * sum over key tiles of dS K
  float acc[kPanels][32];
  zero_acc(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int u = n_tiles + t, s = u % kStages;
    hopper::mbar_wait(&full[s], (u / kStages) & 1);
    const unsigned char* sKs = sK + s * kTile;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    mma_abt<D>(sc, sQ, sKs);
    mma_abt<D>(dp, sDO, sV + s * kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    const int k0 = t * kT;
    uint32_t vis = 0xffffffffu;
    if (k0 + kT > n_valid || (causal && k0 + kT - 1 > q0 + shift)) {
      vis = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + (i >> 2) * 8 + c0 + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1) + shift;
        if (key < n_valid && (!causal || key <= qpos)) vis |= 1u << i;
      }
    }
    // dS = P (dP - Di), P = 2^(S c - lse2), into sc
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = (vis >> i) & 1u ? ex2(sc[i] * scale_log2 - lse[r])
                                      : 0.f;
      sc[i] = p * (dp[i] - di[r]);
    }
    uint32_t hi[16], lo[16];
    split_pack(sc, hi, lo);
    fence_acc(acc);
    hopper::wgmma_fence();
    mma_ab(acc, hi, sKs);
    mma_ab(acc, lo, sKs);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row < Sq)
      store_bf16<D>(dq + (((size_t)b * Sq + row) * Hq + h) * D, acc, r, c0,
                    scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // (B, Sq, Hq, D) bf16
    const __grid_constant__ CUtensorMap tm_k,   // (B, Skv, Hkv, D)
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,  // (B, Sq, Hq, D)
    const float* __restrict__ lse_in, const float* __restrict__ di_in,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ dk_part, float* __restrict__ dv_part, int Sq,
    int Sqp, int Skv, int Hq, int Hkv, int n_valid, int causal, float scale,
    float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "wgmma takes K in steps of 16, "
                "dK and dV in at most two 64-column panels each");
  using L = Smem<D>;
  constexpr int kTile = L::kTile;
  constexpr int kPanels = L::kPanels;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* sK = base;
  unsigned char* sV = base + kTile;
  unsigned char* sQ = base + 2 * kTile;                  // kStages tiles
  unsigned char* sDO = base + (2 + kStages) * kTile;     // kStages tiles
  float* sLse = reinterpret_cast<float*>(base + L::kTiles);  // kStages x 64
  float* sDi = sLse + kStages * kT;                          // kStages x 64
  uint64_t* bars = reinterpret_cast<uint64_t*>(sDi + kStages * kT);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                             // kStages
  uint64_t* empty = bars + 1 + kStages;                  // kStages

  // head fastest, key tile slowest: key tile 0 (in causal attention the
  // longest chain, every query tile) of every head starts first
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kT;
  const int G = Hq / Hkv, hk = h / G, shift = Skv - Sq;
  // the query tiles that see a key of this tile: n_q from q_first
  int q_first = 0, n_q = 0;
  if (k0 < n_valid) {
    q_first = causal ? max(k0 - shift, 0) / kT * kT : 0;
    n_q = q_first < Sq ? (Sq - q_first + kT - 1) / kT : 0;
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers && n_q > 0) {
      hopper::mbar_expect_tx(kv_full, 2 * kTile);
      for (int p = 0; p < kPanels; ++p) {
        hopper::tma_load_4d(sK + p * kPanel, &tm_k, kv_full, 64 * p, hk, k0,
                            b);
        hopper::tma_load_4d(sV + p * kPanel, &tm_v, kv_full, 64 * p, hk, k0,
                            b);
      }
      const float* lse_h = lse_in + ((size_t)b * Hq + h) * Sqp;
      const float* di_h = di_in + ((size_t)b * Hq + h) * Sqp;
      for (int t = 0; t < n_q; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        const int q0 = q_first + t * kT;
        hopper::mbar_expect_tx(&full[s], 2 * kTile + 2 * kT * 4);
        for (int p = 0; p < kPanels; ++p) {
          hopper::tma_load_4d(sQ + s * kTile + p * kPanel, &tm_q, &full[s],
                              64 * p, h, q0, b);
          hopper::tma_load_4d(sDO + s * kTile + p * kPanel, &tm_do,
                              &full[s], 64 * p, h, q0, b);
        }
        // the scratch's rows are Sqp apart: q0 + 64 <= Sqp, 256-byte
        // aligned
        hopper::bulk_load(sLse + s * kT, lse_h + q0, kT * 4, &full[s]);
        hopper::bulk_load(sDi + s * kT, di_h + q0, kT * 4, &full[s]);
      }
    }
    return;
  }

  // consumers: thread (warp w, lane l) holds keys k0 + r0 and k0 + r0 + 8,
  // query columns 8 j + 2 (l % 4) + {0, 1} of each 64-query tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float adk[kPanels][32], adv[kPanels][32];
  zero_acc(adk);
  zero_acc(adv);
  if (n_q > 0) hopper::mbar_wait(kv_full, 0);
  for (int t = 0; t < n_q; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* sQs = sQ + s * kTile;
    const unsigned char* sDOs = sDO + s * kTile;
    const float* lse = sLse + s * kT;   // rows past Sq: +inf (p = 0)
    const float* di = sDi + s * kT;
    const int q0 = q_first + t * kT;
    float st[32], dpt[32];              // S^T, dP^T: keys x queries
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
    mma_abt<D>(st, sK, sQs);
    mma_abt<D>(dpt, sV, sDOs);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    uint32_t vis = 0xffffffffu;
    if (k0 + kT > n_valid || (causal && k0 + kT - 1 > q0 + shift)) {
      vis = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + r0 + 8 * ((i >> 1) & 1);
        const int qpos = q0 + (i >> 2) * 8 + c0 + (i & 1) + shift;
        if (key < n_valid && (!causal || key <= qpos)) vis |= 1u << i;
      }
    }
    // P^T into st, dS^T = P^T (dP^T - Di) into dpt
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = (i >> 2) * 8 + c0 + (i & 1);
      const float p = (vis >> i) & 1u ? ex2(st[i] * scale_log2 - lse[qc])
                                      : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - di[qc]);
    }
    uint32_t ph[16], pl[16], sh[16], sl[16];
    split_pack(st, ph, pl);
    split_pack(dpt, sh, sl);
    fence_acc(adv);
    fence_acc(adk);
    hopper::wgmma_fence();
    mma_ab(adv, ph, sDOs);
    mma_ab(adv, pl, sDOs);
    mma_ab(adk, sh, sQs);
    mma_ab(adk, sl, sQs);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    fence_acc(adv);
    fence_acc(adk);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= Skv) continue;
    if (G == 1) {
      const size_t at = (((size_t)b * Skv + key) * Hkv + hk) * D;
      store_bf16<D>(dk + at, adk, r, c0, scale);
      store_bf16<D>(dv + at, adv, r, c0, 1.f);
    } else {
      // this head's partials, summed over the group by kernel C
      const size_t at = (((size_t)b * Skv + key) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * (j % 8) + 2 * r;
        *reinterpret_cast<float2*>(dk_part + at + 8 * j + c0) =
            make_float2(adk[j / 8][i], adk[j / 8][i + 1]);
        *reinterpret_cast<float2*>(dv_part + at + 8 * j + c0) =
            make_float2(adv[j / 8][i], adv[j / 8][i + 1]);
      }
    }
  }
}

// dk = scale * sum_g dk_part[.., hk G + g, ..] and dv the same unscaled,
// the group's partials added in head order, 4 columns a thread
__global__ void __launch_bounds__(kSumThreads)
flash_attention_bwd_sum_kernel(const float* __restrict__ dk_part,
                               const float* __restrict__ dv_part,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int n4, int G,
                               int Hkv, int D, float scale) {
  const int idx = blockIdx.x * kSumThreads + threadIdx.x;
  if (idx >= n4) return;
  const size_t e = (size_t)idx * 4;
  const int d = (int)(e % D);
  const size_t row = e / D;                  // (b, key, hk) of dk
  const size_t at = (row * G) * D + d;       // (b, key, hk G) of the parts
  float4 sk = __ldg(reinterpret_cast<const float4*>(dk_part + at));
  float4 sv = __ldg(reinterpret_cast<const float4*>(dv_part + at));
  for (int g = 1; g < G; ++g) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(dk_part + at
                                                           + g * D));
    const float4 c = __ldg(reinterpret_cast<const float4*>(dv_part + at
                                                           + g * D));
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + e);
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + e);
  ok[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  ok[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
  ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
  ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// a contiguous (B, S, H, D) bf16 tensor as a 4-D map (d, head, position,
// batch), boxes of 64 d (one panel; past D, zeros) of 64 positions of one
// head (cached, hopper.cuh)
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kT, 1};
  return hopper::bf16_tensor_map(map, ptr, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* di, float* dk_part, float* dv_part, int B, int Sq,
           int Skv, int Hq, int Hkv, int n_valid, int causal, float scale,
           cudaStream_t stream) {
  using L = Smem<D>;
  const int G = Hq / Hkv;
  const size_t kv_bytes = (size_t)B * Skv * Hkv * D * 2;
  // no query: dk and dv are 0; no key: dq is (bf16 0 is 0 bits)
  if (Sq == 0) {
    cudaError_t err = cudaMemsetAsync(dk, 0, kv_bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, kv_bytes, stream);
    return (int)err;
  }
  if (Skv == 0)
    return (int)cudaMemsetAsync(dq, 0, (size_t)B * Sq * Hq * D * 2, stream);
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, B, Sq, Hq, D) || !tensor_map(&tk, k, B, Skv, Hkv, D)
      || !tensor_map(&tv, v, B, Skv, Hkv, D)
      || !tensor_map(&tdo, dout, B, Sq, Hq, D))
    return (int)cudaErrorInvalidValue;
  auto ka = flash_attention_bwd_dq_wgmma_kernel<D>;
  auto kb = flash_attention_bwd_dkdv_wgmma_kernel<D>;
  static const cudaError_t set_a = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kA);
  static const cudaError_t set_b = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kB);
  if (set_a != cudaSuccess) return (int)set_a;
  if (set_b != cudaSuccess) return (int)set_b;
  const int Sqp = (Sq + kT - 1) / kT * kT;
  const __nv_bfloat16* to = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* tdout = static_cast<const __nv_bfloat16*>(dout);
  const float scale_log2 = scale * kLog2e;
  ka<<<dim3(Hq, B, Sqp / kT), kThreads, L::kA, stream>>>(
      tq, tk, tv, tdo, to, tdout, static_cast<__nv_bfloat16*>(dq), lse, di,
      Sq, Sqp, Skv, Hq, Hkv, n_valid, causal, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3(Hq, B, (Skv + kT - 1) / kT), kThreads, L::kB, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dk_part, dv_part, Sq, Sqp, Skv, Hq,
      Hkv, n_valid, causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return (int)err;
  const int n4 = (int)(kv_bytes / 2 / 4);
  flash_attention_bwd_sum_kernel<<<(n4 + kSumThreads - 1) / kSumThreads,
                                   kSumThreads, 0, stream>>>(
      dk_part, dv_part, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n4, G, Hkv, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// built for the head dims of the configs served on the card: 64, 112 and
// 128 (flash_attention.cu)
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, float* lse,
                float* di, float* dk_part, float* dv_part, int B, int Sq,
                int Skv, int Hq, int Hkv, int D, int n_valid, int causal,
                float scale, cudaStream_t stream) {
  if (D == 64)
    return tc::launch<64>(q, k, v, o, dout, dq, dk, dv, lse, di, dk_part,
                          dv_part, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                          scale, stream);
  if (D == 112)
    return tc::launch<112>(q, k, v, o, dout, dq, dk, dv, lse, di, dk_part,
                           dv_part, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                           scale, stream);
  if (D == 128)
    return tc::launch<128>(q, k, v, o, dout, dq, dk, dv, lse, di, dk_part,
                           dv_part, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                           scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kv_valid: keys at or past it are masked (0 = all Skv keys).  lse and
// di: (B, Hq, Sqp) f32 scratch (Sqp = Sq rounded up to 64), written by
// the first kernel and read by the second.  dk_part and dv_part: (B, Skv,
// Hq, D) f32 scratch for the bf16 kernels' per-head partials when Hq >
// Hkv (else not read; may be null).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* di,
    void* dk_part, void* dv_part, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, int kv_valid, int causal, float sm_scale, int bf16, void* stream) {
  const int n_valid = kv_valid > 0 && kv_valid < Skv ? kv_valid : Skv;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || Hq == 0) return 0;
  float* fl = static_cast<float*>(lse);
  float* fd = static_cast<float*>(di);
  return bf16 ? launch_bf16(q, k, v, o, dout, dq, dk, dv, fl, fd,
                            static_cast<float*>(dk_part),
                            static_cast<float*>(dv_part), B, Sq, Skv, Hq,
                            Hkv, D, n_valid, causal, sm_scale, s)
              : cc::launch_dtype<float>(q, k, v, o, dout, dq, dk, dv, fl,
                                        fd, B, Sq, Skv, Hq, Hkv, D, n_valid,
                                        causal, sm_scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
