// Mamba2's SSD (state-space duality) chunked scan.  x (b, S, H, P), B and
// C (b, S, N) (one group) in f32 or bf16; dt (b, S, H) post-softplus, A
// and D (H,) in f32, A < 0.  Out: y (b, S, H, P) in x's dtype and the
// final state (b, H, P, N) in f32, from a zero state.  S is a multiple
// of the chunk Q <= 128 (the wrapper pads with dt = 0 steps).  Per chunk,
// with L the cumulative sum of dt A:
//   y     = [(C B^T) * decay] (dt x) + exp(L) * (C state^T) + D x
//   state = exp(L_Q) state + (x w)^T B,      w = exp(L_Q - L) dt,
// decay[t, j] = exp(L_t - L_j) for j <= t, else 0.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body _ssd_kernel).
//
// Bound on an H100: a chunk of one (row, head) does Q (Q + 1) P flops in
// the intra product (only j <= t), 2 Q P N in C state^T and 2 Q P N in
// the state update; C B^T, Q (Q + 1) N flops a chunk, is head-independent
// with one group, so the function needs it once a (row, chunk).  At the
// serving shape (B 4, S 512, H 32, Q 128, P 64, N 128) that is 2.72 GFLOP
// against 22 MB of bf16 inputs and outputs: 0.041 ms of f32 FMAs on the
// CUDA cores (this kernel's arithmetic), or, with bf16 tensor cores,
// 0.0028 ms, below the 0.0065 ms the bytes take.  The design: the Pallas
// grid (b, H, S/Q) with its sequential chunk axis becomes one block of
// 256 threads per (head, batch row) that walks the chunks in order and
// keeps the (P, N) f32 state in shared memory (4 x 32 = 128 blocks at
// the serving shape, on 132 SMs).  A chunk's B and C (transposed), x
// and dt are staged in shared memory as f32; the
// chunk's rows are then done in blocks of 32: the block's part of C B^T
// at or left of the diagonal block (never above it), masked and decayed
// into M (32 x Q), then its y from M x and C state^T, written out; then
// the state update.  Every product is an f32 FMA loop on the CUDA cores
// over shared memory, with a small register tile a thread; row strides
// of the transposed buffers are padded by one word so that neither the
// transposing stores nor the reads conflict on banks.  216,704 bytes of
// shared memory at P 64, N 128, over the 48 KB default: the launcher
// raises the block's limit first.  Tensor cores (wgmma), sharing C B^T
// across heads (one group makes it head-independent) and a parallel
// cumsum are for a later PR.
//
// Numerics: dt A is rounded before the sequential cumsum, as the plain
// version's cumsum(dt * A); exp is evaluated only at or below the
// diagonal (above it L_t - L_j can be thousands: exp would be inf, and
// inf * 0 NaN); dt is folded into M rather than into x.  Sums run in
// other orders than the plain version's einsums, so outputs differ by
// f32 rounding; bf16 outputs are rounded to nearest-even once, from f32.
// expf is the correctly rounded one (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQmax = 128;       // chunk rows held in shared memory
constexpr int kRB = 32;          // rows of a row block of M and y
constexpr int kQs = kQmax + 1;   // padded row stride of B^T, C^T and M

template <int P, int N>
constexpr int smem_floats() {
  return 2 * N * kQs          // B^T, C^T
         + kQmax * P          // x
         + N * (P + 1)        // state^T, padded
         + kRB * kQs          // M of one row block
         + 4 * kQmax;         // dt, L, exp(L), w
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(
    const T* __restrict__ x,        // (b, S, H, P)
    const float* __restrict__ dt,   // (b, S, H)
    const float* __restrict__ A,    // (H,)
    const T* __restrict__ Bm,       // (b, S, N)
    const T* __restrict__ Cm,       // (b, S, N)
    const float* __restrict__ D,    // (H,)
    T* __restrict__ y,              // (b, S, H, P)
    float* __restrict__ fin,        // (b, H, P, N)
    int S, int H, int Q) {
  static_assert(P % 16 == 0 && N % 16 == 0, "16 x 16 thread tiles");
  constexpr int kPT = P / 16;       // p a thread (y, state)
  constexpr int kNT = N / 16;       // n a thread (state)
  constexpr int kYT = kRB / 16;     // t a thread (y)
  constexpr int kGT = kRB / 8;      // t a thread (M)
  constexpr int kGJ = kQmax / 32;   // j a thread (M)
  extern __shared__ float smem[];
  float* BT = smem;                 // [N][kQs]
  float* CT = BT + N * kQs;         // [N][kQs]
  float* xs = CT + N * kQs;         // [kQmax][P]
  float* stT = xs + kQmax * P;      // [N][P + 1], state[p][n] at [n][p]
  float* Mb = stT + N * (P + 1);    // [kRB][kQs]
  float* dts = Mb + kRB * kQs;      // [kQmax]
  float* Ls = dts + kQmax;
  float* eL = Ls + kQmax;
  float* ws = eL + kQmax;

  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // y and state: 16 x 16
  const int gy = tid >> 5, gx = tid & 31;   // M: 8 x 32
  const float a = A[h], d = D[h];
  const int n_rb = (Q + kRB - 1) / kRB;
  const int Qr = n_rb * kRB;                // rows up to whole row blocks

  for (int e = tid; e < N * (P + 1); e += kThreads) stT[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();  // the previous chunk is done with the buffers
    // stage the chunk; rows Q..Qr-1 are zero
    for (int e = tid; e < Qr * N; e += kThreads) {
      const int t = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (t < Q) {
        const size_t off = ((size_t)bi * S + t0 + t) * N + n;
        bv = attn::to_f32(Bm[off]);
        cv = attn::to_f32(Cm[off]);
      }
      BT[n * kQs + t] = bv;
      CT[n * kQs + t] = cv;
    }
    for (int e = tid; e < Qr * P; e += kThreads) {
      const int t = e / P, p = e % P;
      xs[e] = t < Q ? attn::to_f32(
                          x[(((size_t)bi * S + t0 + t) * H + h) * P + p])
                    : 0.f;
    }
    if (tid < Qr)
      dts[tid] = tid < Q ? dt[((size_t)bi * S + t0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float L = 0.f;
      for (int t = 0; t < Qr; ++t) {
        L += __fmul_rn(dts[t], a);   // dt = 0 past Q: L stays L_Q
        Ls[t] = L;
      }
    }
    __syncthreads();
    const float LQ = Ls[Q - 1];
    if (tid < Qr) {
      eL[tid] = expf(Ls[tid]);
      ws[tid] = expf(LQ - Ls[tid]) * dts[tid];
    }

    for (int rb = 0; rb < n_rb; ++rb) {
      const int r0 = rb * kRB;
      __syncthreads();  // M free; eL and ws written
      // M rows r0 + gy + 8 i, columns gx + 32 k: C B^T for k <= rb (the
      // column blocks at or left of the diagonal block)
      float g[kGT][kGJ];
#pragma unroll
      for (int i = 0; i < kGT; ++i)
#pragma unroll
        for (int k = 0; k < kGJ; ++k) g[i][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float* cr = CT + n * kQs + r0 + gy;
        const float* br = BT + n * kQs + gx;
        float cv[kGT], bv[kGJ];
#pragma unroll
        for (int i = 0; i < kGT; ++i) cv[i] = cr[8 * i];
#pragma unroll
        for (int k = 0; k < kGJ; ++k) bv[k] = k <= rb ? br[32 * k] : 0.f;
#pragma unroll
        for (int i = 0; i < kGT; ++i)
#pragma unroll
          for (int k = 0; k < kGJ; ++k)
            if (k <= rb) g[i][k] = fmaf(cv[i], bv[k], g[i][k]);
      }
#pragma unroll
      for (int i = 0; i < kGT; ++i) {
        const int t = r0 + gy + 8 * i;
        const float Lt = Ls[t];
#pragma unroll
        for (int k = 0; k < kGJ; ++k) {
          const int j = gx + 32 * k;
          // decide the mask first: exp only at or below the diagonal
          Mb[(gy + 8 * i) * kQs + j] =
              j <= t ? g[i][k] * expf(Lt - Ls[j]) * dts[j] : 0.f;
        }
      }
      __syncthreads();
      // y rows r0 + ty + 16 i, columns tx + 16 k
      float yi[kYT][kPT], yo[kYT][kPT];
#pragma unroll
      for (int i = 0; i < kYT; ++i)
#pragma unroll
        for (int k = 0; k < kPT; ++k) yi[i][k] = yo[i][k] = 0.f;
      const int jn = min(Q, r0 + kRB);
      for (int j = 0; j < jn; ++j) {         // intra: M x
        float mv[kYT], xv[kPT];
#pragma unroll
        for (int i = 0; i < kYT; ++i) mv[i] = Mb[(ty + 16 * i) * kQs + j];
#pragma unroll
        for (int k = 0; k < kPT; ++k) xv[k] = xs[j * P + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < kYT; ++i)
#pragma unroll
          for (int k = 0; k < kPT; ++k)
            yi[i][k] = fmaf(mv[i], xv[k], yi[i][k]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {          // inter: C state^T
        float cv[kYT], sv[kPT];
#pragma unroll
        for (int i = 0; i < kYT; ++i) cv[i] = CT[n * kQs + r0 + ty + 16 * i];
#pragma unroll
        for (int k = 0; k < kPT; ++k) sv[k] = stT[n * (P + 1) + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < kYT; ++i)
#pragma unroll
          for (int k = 0; k < kPT; ++k)
            yo[i][k] = fmaf(cv[i], sv[k], yo[i][k]);
      }
#pragma unroll
      for (int i = 0; i < kYT; ++i) {
        const int t = r0 + ty + 16 * i;
        if (t >= Q) continue;
        T* yp = y + (((size_t)bi * S + t0 + t) * H + h) * P;
#pragma unroll
        for (int k = 0; k < kPT; ++k) {
          const int p = tx + 16 * k;
          float v = yi[i][k] + eL[t] * yo[i][k];
          v += d * xs[t * P + p];
          yp[p] = attn::from_f32<T>(v);
        }
      }
    }

    __syncthreads();  // every read of the old state is done
    // state[p][n] = exp(L_Q) state[p][n] + sum_t x[t][p] w[t] B[t][n],
    // n = ty + 16 i, p = tx + 16 k: each thread owns its entries
    float acc[kNT][kPT];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int k = 0; k < kPT; ++k) acc[i][k] = 0.f;
    for (int t = 0; t < Q; ++t) {
      const float wt = ws[t];
      float bv[kNT], xv[kPT];
#pragma unroll
      for (int i = 0; i < kNT; ++i) bv[i] = BT[(ty + 16 * i) * kQs + t];
#pragma unroll
      for (int k = 0; k < kPT; ++k) xv[k] = xs[t * P + tx + 16 * k] * wt;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int k = 0; k < kPT; ++k)
          acc[i][k] = fmaf(xv[k], bv[i], acc[i][k]);
    }
    const float eLQ = expf(LQ);
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int k = 0; k < kPT; ++k) {
        float* s = stT + (ty + 16 * i) * (P + 1) + tx + 16 * k;
        *s = eLQ * *s + acc[i][k];
      }
  }

  __syncthreads();
  float* fp = fin + ((size_t)bi * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    fp[e] = stT[(e % N) * (P + 1) + e / N];
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, void* y, float* fin, int b,
           int S, int H, int Q, cudaStream_t stream) {
  constexpr int smem = smem_floats<P, N>() * (int)sizeof(float);
  auto kern = ssd_scan_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), D, static_cast<T*>(y), fin, S, H, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pn(const void* x, const float* dt, const float* A,
              const void* B, const void* C, const float* D, void* y,
              float* fin, int b, int S, int H, int P, int N, int Q,
              cudaStream_t stream) {
  // built for the (P, N) a configuration runs on the card: mamba2-370m's
  if (P == 64 && N == 128)
    return launch<T, 64, 128>(x, dt, A, B, C, D, y, fin, b, S, H, Q,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               void* y, void* fin, int b, int S, int H,
                               int P, int N, int Q, int bf16, void* stream) {
  if (Q < 1 || Q > kQmax || S < Q || S % Q) return (int)cudaErrorInvalidValue;
  if (b == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* ff = static_cast<float*>(fin);
  return bf16 ? launch_pn<__nv_bfloat16>(x, dtf, Af, B, C, Df, y, ff, b, S,
                                          H, P, N, Q, s)
              : launch_pn<float>(x, dtf, Af, B, C, Df, y, ff, b, S, H, P, N,
                                 Q, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
