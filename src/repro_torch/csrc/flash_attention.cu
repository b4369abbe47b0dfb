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
// In f32 (3xTF32: three tf32 products at 495 TFLOP/s) the same work is
// 11 us, against 5 us for its 16.8 MB at S 512.  zamba2-7b's prefill (B
// 4, S 500, Hq = Hkv = 32, D 112, causal, bf16) moves 57.3 MB (17.1 us)
// for 7.2 GFLOP (7.3 us at the bf16 peak): bytes again; deepseek-moe-16b's
// (Hq = Hkv = 16, D 128) moves 32.8 MB (9.8 us) for 4.1 GFLOP (4.2 us).
//
// Head dims 64, 112 and 128 are built (launch_bf16, launch_f32).  D 128
// is two whole 64-column panels in bf16 and four 32-float panels in f32
// (no zero fill), with D 112's shared memory (82 KB, 193 KB).  A bf16 row
// of 112 is 224 bytes, not a whole number of the 128-byte swizzle rows
// the tensor maps and wgmma's descriptors use, so a tile is D / 64
// panels of 64 columns (two at D 112), each its own TMA box; the box of
// the last panel reaches past D, and TMA fills those 16 columns with
// zeros (counted by the barrier like any byte).  S = Q K^T takes D / 16
// k-steps across the panels (7 at D 112); O is one m64n64 accumulator
// per V panel, P V one product per panel, and only D columns are
// stored.  The f32 kernel does the same with 32-float panels (four at D
// 112, the last half zeros), computes O 64 columns at a time with V^T
// padded to 128 rows (rows past D feed only columns that are not
// stored), and at D 112 takes 193 KB of shared memory, one block an SM.
//
// Two kernels, one per dtype, both on tensor cores;
// flash_attention_launch dispatches on bf16 and a bf16 call never runs
// the f32 kernel.
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
// f32: flash_attention_tf32_kernel, the bf16 kernel's design (producer
// warp, TMA ring of K and V tiles, one consumer warpgroup per 64-row
// query tile, the last tiles first, tiles above the diagonal or past
// n_valid never loaded, a masked key's p exactly 0) with every product
// 3xTF32: a tf32 product keeps 10 mantissa bits (max |d| 3e-3 against
// the 1e-5 check), so each f32 operand v is split into hi (the raw word:
// the tensor cores read an f32 word's top 19 bits, tf32 by truncation)
// and lo = v - trunc(v), and hi hi' + hi lo' + lo hi' go into one f32
// accumulator.  Each wgmma truncates its sum, so a long chain in one
// accumulator drifts: S sums d 0-31 and 32-63 in two accumulators, and
// each tile's P V its own, added in f32 as O = alpha O + P V (one chain
// read just over the 1e-5 check at one seed of S 512; PERF.md).
// tests/test_torch_tf32_design.py models the rounding, the truncating
// sums and ex2.approx's error included.  f32 tiles of 64 rows are two
// 32-float panels (128-byte swizzle).  Per tile: K lo beside K; S = Q
// K^T (K-major on both sides, 3 x 8 products of m64n64k8); then V
// transposed into V^T hi and lo (wgmma reads tf32 only K-major), lo over
// K lo; the stage is released; the online softmax as in bf16
// (ex2.approx, scaled after the product); O's products with P from the
// registers (hi the raw words, lo written here) as the A operand, whose
// 8-key blocks hold their keys in the order 0 2 4 6 1 3 5 7 (hopper.cuh):
// V^T's key columns are written in that order.  Q lo is written once.
// Shared memory: Q and Q lo, one stage of K and V, K lo (then V^T lo)
// and V^T hi, 97 KB: two blocks an SM, so one block's softmax and
// transposes run beside the other's products.  Two stages with V^T
// written while S runs (144 KB, one block an SM) read slower, and Q lo
// in registers gave wrong products after a block's first tile
// (PERF.md).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

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

constexpr int kPanel = kBN * 128;             // 64 rows of 64 bf16

// A 64-row tile of D columns is D / 64 panels of 64 columns (128-byte
// rows, the swizzle's width), the last one filled with zeros past D by
// TMA: D 112 is two panels, the second holding 48 columns and 16 zeros.
template <int D>
struct Smem {
  static constexpr int kPanels = (D + 63) / 64;
  static constexpr int kTile = kPanels * kPanel;  // bytes of a 64-row tile
  static constexpr int kBytes = 1024          // alignment slack
                                + (1 + 2 * kStages) * kTile
                                + (1 + 2 * kStages) * 8;
};

// K step kk (16 wide) of a K-major tile of 64-column panels: panel kk / 4,
// 32 bytes (+2) a step inside it (rows of 128 bytes, 8-row atoms 1024
// apart)
__device__ __forceinline__ uint64_t kdesc16(const unsigned char* tile,
                                            int kk) {
  return hopper::desc_sw128(tile + (kk >> 2) * kPanel, 16, 1024)
         + 2 * (kk & 3);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // (B, Sq, Hq, D) bf16
    const __grid_constant__ CUtensorMap tm_k,  // (B, Skv, Hkv, D)
    const __grid_constant__ CUtensorMap tm_v,
    __nv_bfloat16* __restrict__ o,             // (B, Sq, Hq, D)
    int Sq, int Skv, int Hq, int Hkv, int n_valid, int causal,
    float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "wgmma takes K in steps of 16, "
                "O in at most two 64-column panels");
  constexpr int kTile = Smem<D>::kTile;
  constexpr int kPanels = Smem<D>::kPanels;
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
      // the barriers count whole boxes, zero-filled columns included
      hopper::mbar_expect_tx(q_full, kTile);
      for (int p = 0; p < kPanels; ++p)
        hopper::tma_load_4d(sQ + p * kPanel, &tm_q, q_full, 64 * p, h, q0,
                            b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // the consumers are done with its last use
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * kTile);
        for (int p = 0; p < kPanels; ++p) {
          hopper::tma_load_4d(sK + s * kTile + p * kPanel, &tm_k, &full[s],
                              64 * p, hk, t * kBN, b);
          hopper::tma_load_4d(sV + s * kTile + p * kPanel, &tm_v, &full[s],
                              64 * p, hk, t * kBN, b);
        }
      }
    }
    return;
  }

  // consumers: thread (warp w, lane l) holds rows r0 and r0 + 8 of the
  // tile, columns 8 j + 2 (l % 4) + {0, 1} (hopper.cuh)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  // O, one m64n64 accumulator a 64-column panel of V
  float acc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float m[2] = {attn::kNegInf, attn::kNegInf};
  float l[2] = {0.f, 0.f};   // this lane's share of each row's sum

  // Q and K are K-major (kdesc16).  V is MN-major, one panel a product:
  // a 16-key step is 16 rows of 128 bytes (+128); the leading offset
  // (between 64-column atoms) is unused at N 64.
  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* sKs = sK + s * kTile;
    const unsigned char* sVs = sV + s * kTile;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(sc, kdesc16(sQ, kk), kdesc16(sKs, kk), kk);
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
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) acc[pn][i] *= alpha[r];
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
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) hopper::fence_regs(acc[pn]);
    hopper::wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      const uint64_t dv = hopper::desc_sw128(sVs + pn * kPanel, 1024, 1024);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_m64n64k16_rs_tb(acc[pn], ph[4 * kk], ph[4 * kk + 1],
                                      ph[4 * kk + 2], ph[4 * kk + 3],
                                      dv + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_m64n64k16_rs_tb(acc[pn], pl[4 * kk], pl[4 * kk + 1],
                                      pl[4 * kk + 2], pl[4 * kk + 3],
                                      dv + 128 * kk);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) hopper::fence_regs(acc[pn]);
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
      // the columns past D (zeros of V's last panel) are not stored
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + c0) =
            __floats2bfloat162_rn(acc[j / 8][4 * (j % 8) + 2 * r] * inv,
                                  acc[j / 8][4 * (j % 8) + 2 * r + 1] * inv);
    }
  }
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
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kBN, 1};
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
  // 42 KB at D 64; 82 KB at D 112, over the 48 KB a launch gets unasked
  constexpr int smem = Smem<D>::kBytes;
  auto kern = flash_attention_wgmma_kernel<D>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(Hq, B, (Sq + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv, n_valid,
      causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: tensor cores, 3xTF32 (wgmma), TMA, a producer warp
// ---------------------------------------------------------------------------

namespace tf {

using tc::ex2;
using tc::kBM;
using tc::kBN;
using tc::kConsumers;
using tc::kLog2e;
using tc::kThreads;
// one stage of K and V: with V^T lo over K lo (written once S is done) a
// block fits twice an SM (PERF.md)
constexpr int kStages = 1;
constexpr int kPanel = kBN * 128;             // 64 rows of 32 f32

// A 64-row tile of D columns is D / 32 panels of 32 floats, the last
// filled with zeros past D by TMA (D 112: four panels, 3.5 of them data).
// V^T holds D rounded up to 64 rows (kDp) in two panels of 32 keys; O is
// computed 64 columns at a time (kDp / 64 m64n64 accumulators).
template <int D>
struct Smem {
  static constexpr int kPanels = (D + 31) / 32;
  static constexpr int kDp = (D + 63) / 64 * 64;
  static constexpr int kVTPanel = kDp * 128;        // 32 keys of kDp rows
  static constexpr int kTile = kPanels * kPanel;    // a 64-row f32 tile
  static_assert(2 * kVTPanel == kTile, "V^T fills a tile");
  static constexpr int kQ = 0;                      // Q, then Q lo
  static constexpr int kK = 2 * kTile;              // kStages tiles
  static constexpr int kV = kK + kStages * kTile;   // kStages tiles
  static constexpr int kKL = kV + kStages * kTile;  // K lo, then V^T lo
  static constexpr int kVT = kKL + kTile;           // V^T hi
  static constexpr int kBars = kVT + kTile;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * kStages) * 8;
};

// K step kk's descriptor of a tile of this kernel's panels (``panel``
// bytes apart)
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile,
                                          int kk, int panel = kPanel) {
  return hopper::desc_tf32_k(tile, kk, panel);
}

// D 64: two blocks an SM (97 KB each); D 112: one (193 KB), with room
// for O's two accumulators in registers
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_attention_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // (B, Sq, Hq, D) f32
    const __grid_constant__ CUtensorMap tm_k,  // (B, Skv, Hkv, D)
    const __grid_constant__ CUtensorMap tm_v,
    float* __restrict__ o,                     // (B, Sq, Hq, D)
    int Sq, int Skv, int Hq, int Hkv, int n_valid, int causal,
    float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "S in two accumulators of D / 16 "
                "k-steps each, O in at most two 64-column halves");
  using L = Smem<D>;
  constexpr int kTile = L::kTile;
  constexpr int kHalves = L::kDp / 64;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t pad = (1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* sQ = base + L::kQ;
  unsigned char* sQL = sQ + kTile;
  unsigned char* sK = base + L::kK;
  unsigned char* sV = base + L::kV;
  unsigned char* sKL = base + L::kKL;
  unsigned char* sVT = base + L::kVT;
  unsigned char* sVTL = sKL;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
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
    // producer: one lane issues every copy, L::kPanels 32-float panels a
    // tile (the barriers count whole boxes, zero-filled columns included)
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, kTile);
      for (int k = 0; k < L::kPanels; ++k)
        hopper::tma_load_4d(sQ + k * kPanel, &tm_q, q_full, 32 * k, h, q0,
                            b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // the consumers are done with its last use
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * kTile);
        for (int k = 0; k < L::kPanels; ++k) {
          hopper::tma_load_4d(sK + s * kTile + k * kPanel, &tm_k, &full[s],
                              32 * k, hk, t * kBN, b);
          hopper::tma_load_4d(sV + s * kTile + k * kPanel, &tm_v, &full[s],
                              32 * k, hk, t * kBN, b);
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
  float acc[kHalves][32];                   // O, columns 64 hh + ...
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;
  float m[2] = {attn::kNegInf, attn::kNegInf};
  float l[2] = {0.f, 0.f};   // this lane's share of each row's sum

  hopper::mbar_wait(q_full, 0);
  for (int i = tid; i < kTile / 16; i += kConsumers)
    reinterpret_cast<float4*>(sQL)[i] =
        hopper::tf32_lo4(reinterpret_cast<const float4*>(sQ)[i]);
  // V^T hi (the raw word) and lo: row d, key j at slot tf32_k_slot(j) of
  // its 8; a warp reads 32 keys of one 4-wide chunk of d and writes 32
  // consecutive elements.  Rows D .. kDp - 1 are not written: they feed
  // only O's columns past D, which are not stored.
  auto transpose_v = [&](const unsigned char* sVs) {
    for (int i = tid; i < kBN * D / 4; i += kConsumers) {
      const int j = i & (kBN - 1), dd = (i / kBN) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          sVs + (dd >> 5) * kPanel + hopper::sw128_f32(j, dd & 31));
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const int slot = hopper::tf32_k_slot(j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (slot >> 5) * L::kVTPanel
                        + hopper::sw128_f32(dd + e, slot & 31);
        *reinterpret_cast<float*>(sVT + off) = vv[e];
        *reinterpret_cast<float*>(sVTL + off) = hopper::tf32_lo(vv[e]);
      }
    }
  };
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const unsigned char* sKs = sK + s * kTile;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    for (int i = tid; i < kTile / 16; i += kConsumers)
      reinterpret_cast<float4*>(sKL)[i] =
          hopper::tf32_lo4(reinterpret_cast<const float4*>(sKs)[i]);
    hopper::fence_proxy_async();
    hopper::named_barrier(1, kConsumers);   // Q lo (first tile), K lo

    // S = Q K^T: K-major on both sides, 8-wide K steps of d, the first
    // and the second half of d (0-31 and 32-63 at D 64, 0-55 and 56-111
    // at D 112) in two accumulators added in f32 (the tensor cores' sums
    // truncate: a long chain in one accumulator drifts, PERF.md)
    float sc[32], s2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = s2[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::fence_regs(s2);
    hopper::wgmma_fence();
    auto qk = [&](float (&sk)[32], int kk) {
      const uint64_t dq = kdesc(sQ, kk), dk = kdesc(sKs, kk);
      hopper::wgmma_m64n64k8_tf32_ss(sk, dq, dk, 1);
      hopper::wgmma_m64n64k8_tf32_ss(sk, dq, kdesc(sKL, kk), 1);
      hopper::wgmma_m64n64k8_tf32_ss(sk, kdesc(sQL, kk), dk, 1);
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) qk(sc, kk);
#pragma unroll
    for (int kk = D / 16; kk < D / 8; ++kk) qk(s2, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    hopper::fence_regs(s2);
    transpose_v(sV + s * kTile);            // V^T lo over K lo
    hopper::fence_proxy_async();
    hopper::named_barrier(1, kConsumers);   // V^T written; K, V read
    if (lane == 0) hopper::mbar_arrive(&empty[s]);

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
      sc[i] = (sc[i] + s2[i]) * scale_log2;
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
    float pl[32];                           // P lo
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = (vis >> i) & 1u ? ex2(sc[i] - m[r]) : 0.f;
      sc[i] = p;
      pl[i] = hopper::tf32_lo(p);
      ps[r] += p;
    }
    l[0] = l[0] * alpha[0] + ps[0];
    l[1] = l[1] * alpha[1] + ps[1];

    // P V into its own accumulator (s2, free again), then O = alpha O +
    // P V in f32, 64 columns of O (V^T rows 64 hh ..) at a time; P's
    // registers are the A operand of 8-key step kk, in the permuted K
    // order that V^T's columns follow
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) {
      const unsigned char* vt = sVT + hh * kPanel;
      const unsigned char* vtl = sVTL + hh * kPanel;
#pragma unroll
      for (int i = 0; i < 32; ++i) s2[i] = 0.f;
      hopper::fence_regs(s2);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) {
        const uint64_t dv = kdesc(vt, kk, L::kVTPanel);
        hopper::wgmma_m64n64k8_tf32_rs(s2, sc[4 * kk], sc[4 * kk + 2],
                                       sc[4 * kk + 1], sc[4 * kk + 3], dv);
        hopper::wgmma_m64n64k8_tf32_rs(s2, sc[4 * kk], sc[4 * kk + 2],
                                       sc[4 * kk + 1], sc[4 * kk + 3],
                                       kdesc(vtl, kk, L::kVTPanel));
        hopper::wgmma_m64n64k8_tf32_rs(s2, pl[4 * kk], pl[4 * kk + 2],
                                       pl[4 * kk + 1], pl[4 * kk + 3], dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s2);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[hh][i] = acc[hh][i] * alpha[(i >> 1) & 1] + s2[i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt == 0.f ? 0.f : 1.f / lt;  // no visible key: 0
    const int row = q0 + r0 + 8 * r;
    if (row < Sq) {
      float* op = o + (((size_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(op + 8 * j + c0) =
            make_float2(acc[j / 8][4 * (j % 8) + 2 * r] * inv,
                        acc[j / 8][4 * (j % 8) + 2 * r + 1] * inv);
    }
  }
}

// a contiguous (B, S, H, D) f32 tensor as a 4-D map (d, head, position,
// batch), boxes of 32 d (past D, zeros) of 64 positions of one head
// (cached, hopper.cuh)
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)S * H * D * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)kBN, 1};
  return hopper::f32_tensor_map(map, ptr, 4, dims, strides, box);
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
  auto kern = flash_attention_tf32_kernel<D>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(Hq, B, (Sq + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), Sq, Skv, Hq, Hkv, n_valid, causal,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tf

// built for the head dims of the configs served on the card: 64
// (qwen2-0.5b, stablelm-1.6b), 112 (zamba2-7b) and 128 (deepseek-moe-16b,
// and the heads of grok-1-314b, deepseek-67b and deepseek-coder-33b)
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, int D, int n_valid,
               int causal, float scale, cudaStream_t stream) {
  if (D == 64)
    return tf::launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                          scale, stream);
  if (D == 112)
    return tf::launch<112>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                           scale, stream);
  if (D == 128)
    return tf::launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                           scale, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int D, int n_valid,
                int causal, float scale, cudaStream_t stream) {
  if (D == 64)
    return tc::launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                          scale, stream);
  if (D == 112)
    return tc::launch<112>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                           scale, stream);
  if (D == 128)
    return tc::launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal,
                           scale, stream);
  return (int)cudaErrorInvalidValue;
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
