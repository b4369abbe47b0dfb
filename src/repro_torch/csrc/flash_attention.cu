// Flash attention: causal or full GQA attention with an online softmax,
// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), f32 or bf16 in, softmax
// and sums in f32, out (B, Sq, Hq, D) in q's dtype.  Queries sit at the
// END of the key axis when Sq < Skv (query i is at position
// Skv - Sq + i); keys at or past n_valid are masked (the ragged edge of
// a sequence that is no multiple of a block, or padding); a query row
// that sees no key gives 0.  GQA reads KV head h / (Hq / Hkv) for query
// head h: no repeated K/V in memory.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//   (body _fa_kernel).
//
// Bound on an H100: prefill at the serving shape (B 4, S 500, Hq 14,
// Hkv 2, D 64, causal, bf16) reads 4.6 MB and writes 3.6 MB (2.4 us at
// 3.35 TB/s) and needs 4 * D flops for each of the 4 * 14 * 125,250
// visible (query, key) pairs, 1.8 GFLOP: 1.8 us at the 989 TFLOP/s bf16
// tensor-core peak, 27 us at the 67 TFLOP/s f32 CUDA-core peak.  So bf16
// is bound by bytes on paper, and only tensor cores come near that line.
//
// Two kernels, one per dtype; flash_attention_launch dispatches on bf16
// and a bf16 call never runs the f32 kernel.
//
// bf16: flash_attention_wgmma_kernel, on tensor cores.  One block per
// (64-row query tile, q head, batch row): one consumer warpgroup owns the
// tile (64 is wgmma's M) and one producer warp feeds it.  The producer
// loads the Q tile once and K/V tiles of 64 keys into a ring of kStages
// stages in dynamic shared memory with TMA (4-D tensor maps over
// (d, head, position, batch), built by the launcher and kept for the
// next call on the same addresses, passed as __grid_constant__
// parameters; 128-byte swizzle, the layout wgmma's
// descriptors read), signalling "full" mbarriers; the consumers release
// each stage through an "empty" mbarrier.  At the prefill's shape 396 of
// the 448 blocks are resident at once (116 registers and 42 KB a block:
// 3 an SM), so the time is mostly the longest blocks' chains of tiles:
// blocks are numbered so that the last query tiles, which see the most
// keys, start first.  Along a chain the softmax's scalar work, not the
// tensor cores, sets the pace: hence ex2.approx and no mask inside the
// diagonal.  Two consumer warpgroups splitting a tile's keys, 3 or 4
// stages, no producer warp, and 96 registers (4 blocks an SM, with
// spills) were tried: slower or no faster (PERF.md).  Per tile the
// consumers run
// S = Q K^T as 4 wgmma m64n64k16 (bf16 in, f32 accumulators, both from
// shared memory), scale S by sm_scale * log2(e) in f32 after the product,
// mask, take the online softmax in registers (ex2.approx, each row's max
// and sum over the 4 lanes that hold it), rescale O, then O += P V with P
// from registers (the accumulator's layout is the A operand's) and V
// from shared memory (MN-major).  Tiles wholly above the causal diagonal
// or past n_valid are never loaded, tiles wholly below it and inside
// n_valid skip the mask; TMA fills rows past Sq or Skv (the
// ragged edge, S 500 = 7 x 64 + 52) with zeros, and the stores are masked
// by row.  A masked key's p is set to exactly 0 (never exp(NEG_INF - m)
// with a real m), so a row with no visible key keeps l = 0 and writes 0.
//
// Numerics (bf16): Q K^T products of bf16 are exact in f32, only the
// order of the sums differs from the plain version.  P is not rounded to
// bf16 once, as FlashAttention-2 does (an error of about 2^-9 / sqrt(n)
// per output over n diffuse keys, more than one bf16 ulp of an output
// near 1e-5): it is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// and both products go into the same f32 accumulator, so P carries about
// 16 bits (half again the tensor work, negligible at 1.8 GFLOP).
// ex2.approx adds a relative error of about 2^-22 to each p, and the
// output is acc times 1 / l.  The outputs then differ from the plain
// version by f32 rounding, rounded to bf16: at most one bf16 ulp.
//
// f32: flash_attention_kernel, the first port's kernel, unchanged: f32
// FMAs on the CUDA cores (TF32 tensor cores keep 10 mantissa bits and
// cannot meet the 1e-5 check).  One block of 64 threads per (64-row query
// tile, q head, batch row), each thread holding one query row
// (pre-scaled), its running max m, denominator l and D-wide accumulator
// in registers; K/V tiles of 64 keys are staged through shared memory as
// f32 (every thread reads the same key: a broadcast); the softmax is
// rescaled once per 16 keys.  The dot products are fmaf chains in d
// order, and the softmax is rescaled every 16 keys where the plain
// version rescales every 128: outputs differ from it by f32 rounding
// (about 1e-7 at the serving shape).  expf is the correctly rounded one
// (no fast math).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------


constexpr int kBQ = 64;   // query rows per block, one per thread
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kSub = 16;  // keys per softmax rescale

template <typename T, int D>
__global__ void __launch_bounds__(kBQ) flash_attention_kernel(
    const T* __restrict__ q,  // (B, Sq, Hq, D)
    const T* __restrict__ k,  // (B, Skv, Hkv, D)
    const T* __restrict__ v,
    T* __restrict__ o,        // (B, Sq, Hq, D)
    int Sq, int Skv, int Hq, int Hkv, int n_valid, int causal,
    float scale) {
  constexpr int V = attn::Ld<T>::N;
  __shared__ __align__(16) float Ks[kBK][D];
  __shared__ __align__(16) float Vs[kBK][D];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + threadIdx.x;
  const bool live = row < Sq;
  const int shift = Skv - Sq;
  const int qpos = row + shift;  // absolute position of this query

  float qr[D];
  if (live) {
    const T* qp = q + (((size_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; d += V) attn::Ld<T>::load(qp + d, qr + d);
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] *= scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  // keys any row of this tile can see
  int kend = n_valid;
  if (causal) kend = min(kend, min(q0 + kBQ, Sq) + shift);

  float m = attn::kNegInf, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, kend - k0);
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < kBK * (D / V); c += kBQ) {
      const int j = c / (D / V);
      const int d = (c % (D / V)) * V;
      if (j < nk) {
        const size_t off = (((size_t)b * Skv + k0 + j) * Hkv + hk) * D + d;
        attn::Ld<T>::load(k + off, &Ks[j][d]);
        attn::Ld<T>::load(v + off, &Vs[j][d]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) Ks[j][d + i] = Vs[j][d + i] = 0.f;
      }
    }
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += kSub) {
      float s[kSub];
      float mt = attn::kNegInf;
      unsigned vis = 0;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][d]);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        s[jj] = dot;
        if (j < nk && (!causal || k0 + j <= qpos)) {
          vis |= 1u << jj;
          mt = fmaxf(mt, dot);
        }
      }
      if (!vis) continue;  // p = 0 and alpha = 1: nothing changes
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        s[jj] = (vis >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
        ps += s[jj];
      }
      l = l * alpha + ps;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float a0 = acc[d] * alpha, a1 = acc[d + 1] * alpha;
        float a2 = acc[d + 2] * alpha, a3 = acc[d + 3] * alpha;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[j0 + jj][d]);
          a0 = fmaf(s[jj], vv.x, a0);
          a1 = fmaf(s[jj], vv.y, a1);
          a2 = fmaf(s[jj], vv.z, a2);
          a3 = fmaf(s[jj], vv.w, a3);
        }
        acc[d] = a0; acc[d + 1] = a1; acc[d + 2] = a2; acc[d + 3] = a3;
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = l == 0.f ? 1.f : l;  // no visible key: acc = 0
  T* op = o + (((size_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = attn::from_f32<T>(acc[d] / den);
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, a producer warp
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 64;                       // query rows a block
constexpr int kBN = 64;                       // keys a tile
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kConsumers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22, far
// below a bf16 ulp; results under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Smem {
  static constexpr int kTile = kBN * D * 2;   // bytes of a 64-row bf16 tile
  static constexpr int kBytes = 1024          // alignment slack
                                + (1 + 2 * kStages) * kTile
                                + (1 + 2 * kStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // (B, Sq, Hq, D) bf16
    const __grid_constant__ CUtensorMap tm_k,  // (B, Skv, Hkv, D)
    const __grid_constant__ CUtensorMap tm_v,
    __nv_bfloat16* __restrict__ o,             // (B, Sq, Hq, D)
    int Sq, int Skv, int Hq, int Hkv, int n_valid, int causal,
    float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "wgmma takes K in steps of 16");
  static_assert(D == 64, "one 128-byte swizzle row holds 64 bf16: other "
                "head dims need more panels");
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t pad = (1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* sQ = base;
  unsigned char* sK = base + kTile;                  // kStages tiles
  unsigned char* sV = base + (1 + kStages) * kTile;  // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (1 + 2 * kStages)
                                               * kTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                         // kStages
  uint64_t* empty = bars + 1 + kStages;              // kStages

  // blocks start in the order of their linear index: the heavy causal
  // tiles (the last rows, which see the most keys) of every head first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBM;
  const int shift = Skv - Sq;
  // keys any row of this tile can see
  int kend = n_valid;
  if (causal) kend = min(kend, min(q0 + kBM, Sq) + shift);
  const int n_tiles = kend > 0 ? (kend + kBN - 1) / kBN : 0;

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
    // producer: one lane issues every copy
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, kTile);
      hopper::tma_load_4d(sQ, &tm_q, q_full, 0, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // the consumers are done with its last use
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * kTile);
        hopper::tma_load_4d(sK + s * kTile, &tm_k, &full[s], 0, hk,
                            t * kBN, b);
        hopper::tma_load_4d(sV + s * kTile, &tm_v, &full[s], 0, hk,
                            t * kBN, b);
      }
    }
    return;
  }

  // consumers: thread (warp w, lane l) holds rows r0 and r0 + 8 of the
  // tile, columns 8 j + 2 (l % 4) + {0, 1} (hopper.cuh)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {attn::kNegInf, attn::kNegInf};
  float l[2] = {0.f, 0.f};   // this lane's share of each row's sum

  // K-major descriptors (Q, K): rows of 128 bytes, 8-row atoms 1024
  // apart; a 16-wide K step is 32 bytes (+2).  V is MN-major: a 16-key
  // step is 16 rows of 128 bytes (+128); its leading offset (between
  // 64-column atoms) is unused at N = D = 64.
  const uint64_t dq = hopper::desc_sw128(sQ, 16, 1024);
  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const uint64_t dk = hopper::desc_sw128(sK + s * kTile, 16, 1024);
    const uint64_t dv = hopper::desc_sw128(sV + s * kTile, 1024, 1024);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // mask (bit i of vis: sc[i] is visible; every key of a tile below
    // the diagonal and inside n_valid is) and scale; each row's max
    const int k0 = t * kBN;
    uint32_t vis = 0xffffffffu;
    if (k0 + kBN > n_valid || (causal && k0 + kBN - 1 > q0 + shift)) {
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
      const int r = (i >> 1) & 1;
      sc[i] *= scale_log2;
      if ((vis >> i) & 1u) mx[r] = fmaxf(mx[r], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no visible key yet: m = m_new = kNegInf, alpha = 1 (acc, l are 0)
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = (vis >> i) & 1u ? ex2(sc[i] - m[r]) : 0.f;
      sc[i] = p;
      ps[r] += p;
      acc[i] *= alpha[r];
    }
    l[0] = l[0] * alpha[0] + ps[0];
    l[1] = l[1] * alpha[1] + ps[1];

    // P = P_hi + P_lo, both bf16, packed in pairs as the A operand
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * i],
                                                      sc[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(sc[2 * i] - hf.x,
                                                      sc[2 * i + 1] - hf.y);
      ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[i] = *reinterpret_cast<const uint32_t*>(&lo);
    }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      hopper::wgmma_m64n64k16_rs_tb(acc, ph[4 * kk], ph[4 * kk + 1],
                                    ph[4 * kk + 2], ph[4 * kk + 3],
                                    dv + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      hopper::wgmma_m64n64k16_rs_tb(acc, pl[4 * kk], pl[4 * kk + 1],
                                    pl[4 * kk + 2], pl[4 * kk + 3],
                                    dv + 128 * kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt == 0.f ? 0.f : 1.f / lt;  // no visible key: 0
    const int row = q0 + r0 + 8 * r;
    if (row < Sq) {
      __nv_bfloat16* op = o + (((size_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// a contiguous (B, S, H, D) bf16 tensor as a 4-D map (d, head, position,
// batch), boxes of 64 positions of one head (cached, hopper.cuh)
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)kBN, 1};
  return hopper::bf16_tensor_map(map, ptr, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int n_valid, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Sq, Hq, D)
      || !tensor_map(&tk, k, B, Skv, Hkv, D)
      || !tensor_map(&tv, v, B, Skv, Hkv, D))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<D>::kBytes;
  static_assert(smem <= 48 * 1024, "more dynamic shared memory needs "
                "cudaFuncAttributeMaxDynamicSharedMemorySize");
  const dim3 grid(Hq, B, (Sq + kBM - 1) / kBM);
  flash_attention_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv, n_valid,
      causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, int D, int n_valid,
               int causal, float scale, cudaStream_t stream) {
  // built for the head dim of the configs served on the card (64)
  if (D != 64) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<float, 64><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, Hq, Hkv,
      n_valid, causal, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int D, int n_valid,
                int causal, float scale, cudaStream_t stream) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  return tc::launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                        scale, stream);
}

}  // namespace

// kv_valid: keys at or past it are masked (0 = all Skv keys)
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int D,
                                      int kv_valid, int causal,
                                      float sm_scale, int bf16,
                                      void* stream) {
  const int n_valid = kv_valid > 0 && kv_valid < Skv ? kv_valid : Skv;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  return bf16 ? launch_bf16(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, n_valid,
                            causal, sm_scale, s)
              : launch_f32(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, n_valid,
                           causal, sm_scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
