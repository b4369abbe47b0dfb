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
// tensor-core peak, 27 us at the 67 TFLOP/s f32 CUDA-core peak.  So it
// is bound by bytes on paper and by operations on the cores it uses:
// this first kernel does not use tensor cores, it runs on the CUDA
// cores in f32.  The design: the Pallas kernel's sequential KV grid
// axis becomes a loop inside the block; one block of
// 64 threads per (64-row query tile, q head, batch row), each thread
// holding one query row (pre-scaled), its running max m, denominator l
// and D-wide accumulator in registers; K/V tiles of 64 keys are staged
// through shared memory as f32 (every thread reads the same key: a
// broadcast); the softmax is rescaled once per 16 keys; tiles wholly
// above the causal diagonal or past n_valid are never loaded.  Masked
// keys contribute exactly 0 (the reference's exp(NEG_INF - m) with a
// real m), so a row with no visible key keeps l = 0 and writes 0.
// Tensor cores (wgmma), TMA and a warp-specialised pipeline are later
// work.
//
// Numerics: the dot products are fmaf chains in d order, and the
// softmax is rescaled every 16 keys where the plain version rescales
// every 128: outputs differ from it by f32 rounding (about 1e-7 at the
// serving shape), and in bf16 by at most one bf16 ulp.  expf is the
// correctly rounded one (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

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

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int Sq, int Skv, int Hq, int Hkv, int n_valid, int causal,
            float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, D><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv,
      n_valid, causal, scale);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int Hq, int Hkv, int D, int n_valid,
             int causal, float scale, cudaStream_t stream) {
  // built for the head dim of the configs served on the card (64)
  if (D != 64) return (int)cudaErrorInvalidValue;
  launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, n_valid, causal, scale,
                stream);
  return (int)cudaGetLastError();
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
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                         n_valid, causal, sm_scale, s)
              : launch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, n_valid,
                                causal, sm_scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
