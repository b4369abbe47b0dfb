// The gradient of flash attention: dQ, dK and dV of
//   O = softmax(sm_scale * Q K^T + mask) V
// for q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), the forward's output o
// (B, Sq, Hq, D) and its gradient do, all f32 or all bf16; dq, dk and dv
// come out in the same dtype, every product and sum in f32.  The masks
// are the forward's (csrc/flash_attention.cu): queries at the END of the
// key axis when Sq < Skv (query i at position Skv - Sq + i), keys at or
// past n_valid masked, a query row that sees no key gives 0 (and zero
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
// tensor-core peak, so operations bound it.  This kernel runs its
// products on CUDA cores (67 TFLOP/s f32 peak, 1.1 ms for the same work)
// and recomputes Q K^T twice, 16 D flops a pair.
//
// Design, simple first (speed is later work): CUDA cores, f32 FMAs out of
// shared memory, two kernels, no atomics, so the result is deterministic.
//
// Kernel A (flash_attention_bwd_dq_kernel), one block of 256 threads per
// (64-row query tile, q head, batch row), last query tiles first (they
// see the most keys).  Q and dO of the tile stay in shared memory; K and
// V tiles of 64 keys pass through.  Pass 1 recomputes each row's max and
// log-sum-exp over its visible keys (per thread over its columns, then
// across the 16 threads of a row with shuffles) and Di = rowsum(dO * O);
// it writes both to the scratch the second kernel reads.  Pass 2
// recomputes P = exp(S - lse), dP = dO V^T, dS = P (dP - Di), and
// accumulates dQ += dS K in registers; dQ = sm_scale * that.
//
// Kernel B (flash_attention_bwd_dkdv_kernel), one block per (64-key
// tile, KV head, batch row).  K and V of the tile stay in shared memory;
// for each query head of the KV head's group and each query tile that
// sees a key of the tile it loads Q, dO, lse and Di, recomputes P^T and
// dS^T = P^T (dP^T - Di) (keys x queries), and accumulates dV += P^T dO
// and dK += dS^T Q in registers: the group's sum is taken inside the
// block.  dK = sm_scale * that.
//
// Tiles are 64 x 64; thread (ty, tx) of the 16 x 16 grid owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4) of a score tile, and rows
// ty + 16 i and head-dim columns tx + 16 j (j < D / 16) of an
// accumulator.  Rows of a tile lie in shared memory with a stride of
// D + 1 floats (odd), so the 16 columns a warp reads at one d fall in 16
// banks.  Masked scores give P = 0 exactly: a row with no visible key
// has lse = +inf and contributes nothing.  Built for head dims 64, 112
// and 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"

namespace {

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

}  // namespace

// kv_valid: keys at or past it are masked (0 = all Skv keys).  lse and
// di: (B, Hq, Sq) f32 scratch, written by the first kernel and read by
// the second.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* di,
    int B, int Sq, int Skv, int Hq, int Hkv, int D, int kv_valid, int causal,
    float sm_scale, int bf16, void* stream) {
  const int n_valid = kv_valid > 0 && kv_valid < Skv ? kv_valid : Skv;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || Hq == 0) return 0;
  float* fl = static_cast<float*>(lse);
  float* fd = static_cast<float*>(di);
  return bf16 ? launch_dtype<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, fl,
                                            fd, B, Sq, Skv, Hq, Hkv, D,
                                            n_valid, causal, sm_scale, s)
              : launch_dtype<float>(q, k, v, o, dout, dq, dk, dv, fl, fd, B,
                                    Sq, Skv, Hq, Hkv, D, n_valid, causal,
                                    sm_scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
