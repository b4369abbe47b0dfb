// Decode attention: one new query token per batch row against its KV
// cache.  q (B, Hq, D), k and v (B, S, Hkv, D), kv_len (B,) int32 valid
// lengths; keys at or past kv_len[b] are masked.  The G = Hq / Hkv query
// heads of a KV head are packed together (q head h reads KV head h / G).
// f32 or bf16 in, online softmax in f32, out (B, Hq, D) in q's dtype; a
// row with kv_len 0 gives 0.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
//   (body _dec_kernel).
//
// Bound on an H100: decode is memory-bound.  Each call must read the
// valid prefix of K and V once (kv_len * Hkv * D * 2 elements a row:
// 512 KB a row at kv_len 1024, bf16) and does 4 * D flops per (q head,
// key), about one flop a byte, far below the card's ridge.  At the
// serving shape (B 4, Hkv 2) one block per (KV head, batch row) would
// leave 124 of 132 SMs idle and walk up to 16 key tiles in series, so the
// keys are split over a thread block cluster of kSplit = 16 blocks per
// (KV head, batch row): 128 blocks, one launch, no scratch in device
// memory, no atomics.  Every block reads kv_len[b] on the device and
// takes the 64-key tiles rank, rank + kSplit, ... of the valid prefix
// (at kv_len 1024 one tile each); the grid depends on B and Hkv only, so
// a captured CUDA graph replays for any lengths.  A block streams its
// tiles through shared memory (f32, K rows padded by one word so that
// the per-key dot products read without bank conflicts): scores for the
// G x 64 (head, key) pairs, one warp per head for the tile's max, exp
// and sum, then the G x D accumulator (a few entries a thread, in
// registers) is rescaled and updated.  Its partial softmax (m, l, and
// the unnormalised accumulator) then stays in its own shared memory;
// after a cluster barrier every block merges a 1/kSplit slice of the
// G x D outputs from all kSplit partials through distributed shared
// memory (f32, rescaled by exp(m_r - max_r m_r)) and writes it, and a
// second cluster barrier keeps each block's shared memory alive until
// the others have read it.  A block with no tile (kv_len 1 or 61 leaves
// most of the cluster idle) still passes both barriers, with m = -FLT_MAX,
// l = 0 and a zero accumulator, which weigh exactly 0 in the merge; a row
// with kv_len 0 merges to l = 0 and writes 0.
//
// Head dims 64, 112 and 128 are built.  Shared memory is dynamic (45 KB
// a block at D 64, 76 KB at D 112, 86 KB at D 128, over the 48 KB a
// launch gets unasked).  zamba2-7b is MHA (G = 1): 16 x 32 x 4 = 2048
// blocks at B 4, each reading at most a tile of 64 keys at kv_len 1024;
// the call must read 22.9 MB of K and V at kv_len (1, 61, 512, 1024), 6.8
// us at 3.35 TB/s.  deepseek-moe-16b (MHA, 16 heads of 128) reads 13.1 MB
// there (3.9 us) over 1024 blocks.
//
// Numerics: dot products are fmaf chains in d order and the softmax is
// online by tiles of 64 and merged across blocks, where the plain version
// takes one softmax over the whole row: outputs differ from it by f32
// rounding, in bf16 by at most one bf16 ulp.  expf is the correctly
// rounded one (no fast math).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;    // keys per tile: two per lane in the softmax
constexpr int kMaxG = 16;  // query heads per KV head
constexpr int kSplit = 16;  // blocks of a cluster, each a share of the keys

namespace cg = cooperative_groups;

// A block's shared memory (dynamic: 45 KB at D 64, 76 KB at D 112, 86 KB
// at D 128), byte
// offsets of q (scaled, f32), the K tile (rows padded by one word), the V
// tile, the scores, the row statistics and the partial accumulator
template <int D>
struct Smem {
  static constexpr int kQ = 0;                            // [kMaxG][D]
  static constexpr int kK = kQ + kMaxG * D * 4;           // [kBK][D + 1]
  static constexpr int kV = (kK + kBK * (D + 1) * 4 + 15) / 16 * 16;
  static constexpr int kP = kV + kBK * D * 4;             // [kMaxG][kBK]
  static constexpr int kRow = kP + kMaxG * kBK * 4;       // m, l, a
  static constexpr int kPart = kRow + 3 * kMaxG * 4;      // [kMaxG * D]
  static constexpr int kBytes = kPart + kMaxG * D * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q,             // (B, Hq, D)
    const T* __restrict__ k,             // (B, S, Hkv, D)
    const T* __restrict__ v,
    const int32_t* __restrict__ kv_len,  // (B,)
    T* __restrict__ o,                   // (B, Hq, D)
    int S, int Hq, int Hkv, float scale) {
  constexpr int V = attn::Ld<T>::N;
  constexpr int kOut = (kMaxG * D + kThreads - 1) / kThreads;
  using L = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float (*qs)[D] = reinterpret_cast<float (*)[D]>(smem + L::kQ);
  float (*Ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem + L::kK);
  float (*Vs)[D] = reinterpret_cast<float (*)[D]>(smem + L::kV);
  float (*P)[kBK] = reinterpret_cast<float (*)[kBK]>(smem + L::kP);
  float* m_row = reinterpret_cast<float*>(smem + L::kRow);
  float* l_row = m_row + kMaxG;
  float* a_row = l_row + kMaxG;
  float* part = reinterpret_cast<float*>(smem + L::kPart);  // unnormalised
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = min(max(kv_len[b], 0), S);

  const T* qp = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  for (int e = tid; e < G * D; e += kThreads)
    qs[e / D][e % D] = attn::to_f32(qp[e]) * scale;
  if (tid < G) {
    m_row[tid] = attn::kNegInf;
    l_row[tid] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

  for (int k0 = rank * kBK; k0 < n; k0 += kSplit * kBK) {
    const int nk = min(kBK, n - k0);
    __syncthreads();  // q staged / the previous tile consumed
    for (int c = tid; c < kBK * (D / V); c += kThreads) {
      const int j = c / (D / V);
      const int d = (c % (D / V)) * V;
      float kt[V], vt[V];
      if (j < nk) {
        const size_t off = (((size_t)b * S + k0 + j) * Hkv + hk) * D + d;
        attn::Ld<T>::load(k + off, kt);
        attn::Ld<T>::load(v + off, vt);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kt[i] = vt[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        Ks[j][d + i] = kt[i];
        Vs[j][d + i] = vt[i];
      }
    }
    __syncthreads();
    for (int pr = tid; pr < G * kBK; pr += kThreads) {
      const int g = pr / kBK, j = pr % kBK;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qs[g][d], Ks[j][d], dot);
      P[g][j] = dot;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const bool ok0 = lane < nk, ok1 = lane + 32 < nk;
      const float s0 = P[g][lane], s1 = P[g][lane + 32];
      float mt = fmaxf(ok0 ? s0 : attn::kNegInf, ok1 ? s1 : attn::kNegInf);
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_row[g];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      P[g][lane] = p0;
      P[g][lane + 32] = p1;
      float ps = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_row[g] = alpha;
        l_row[g] = l_row[g] * alpha + ps;
        m_row[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        float a = acc[i] * a_row[g];
        for (int j = 0; j < nk; ++j) a = fmaf(P[g][j], Vs[j][d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // l_row final (and initialised without a tile)
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * D) part[idx] = acc[i];
  }
  cluster.sync();  // every block's partial is in its shared memory

  // this block's slice of the G x D outputs, merged over the cluster
  const int per = (G * D + kSplit - 1) / kSplit;
  const int idx = rank * per + tid;
  if (tid < per && idx < G * D) {
    const int g = idx / D;
    float mr[kSplit];
    float mx = attn::kNegInf;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      mr[r] = *cluster.map_shared_rank(&m_row[g], r);
      mx = fmaxf(mx, mr[r]);
    }
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float w = expf(mr[r] - mx);  // 0 for a block without a tile
      l = fmaf(*cluster.map_shared_rank(&l_row[g], r), w, l);
      a = fmaf(*cluster.map_shared_rank(&part[idx], r), w, a);
    }
    T* op = o + ((size_t)b * Hq + (size_t)hk * G) * D;
    op[idx] = attn::from_f32<T>(a / (l == 0.f ? 1.f : l));
  }
  cluster.sync();  // the others' shared memory is read
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_len,
           void* o, int B, int S, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  const auto kernel = decode_attention_kernel<T, D>;
  constexpr int smem = Smem<D>::kBytes;
  // 16 blocks a cluster is over the portable 8; past 48 KB of shared
  // memory a launch must ask
  static const cudaError_t set = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }();
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), S, Hq, Hkv,
      scale);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v,
             const int32_t* kv_len, void* o, int B, int S, int Hq, int Hkv,
             int D, float scale, cudaStream_t stream) {
  // built for the head dims of the configs served on the card: 64
  // (qwen2-0.5b, stablelm-1.6b), 112 (zamba2-7b) and 128
  // (deepseek-moe-16b; grok-1-314b's, deepseek-67b's and
  // deepseek-coder-33b's heads)
  if (D == 64)
    return launch<T, 64>(q, k, v, kv_len, o, B, S, Hq, Hkv, scale, stream);
  if (D == 112)
    return launch<T, 112>(q, k, v, kv_len, o, B, S, Hq, Hkv, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, kv_len, o, B, S, Hq, Hkv, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int32_t* kv_len,
                                       void* o, int B, int S, int Hq,
                                       int Hkv, int D, float sm_scale,
                                       int bf16, void* stream) {
  if (Hkv == 0 || Hq / Hkv > kMaxG || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, kv_len, o, B, S, Hq, Hkv, D,
                                         sm_scale, s)
              : launch_d<float>(q, k, v, kv_len, o, B, S, Hq, Hkv, D,
                                sm_scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
