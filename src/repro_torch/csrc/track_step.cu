// One fused recurrent-tracker step for K streams of Q slots: detection
// features, the (Q, Q) match logits, the cost assembly, the JV solve on the
// canonical assoc_side square, and both GRU batches.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/track_step/kernel.py::track_step_pallas
// (body step_core, with kernels/assign/kernel.py::solve_one inline).
//
// Numerics: every transcendental and multiply-add goes through
// fastmath.cuh and every product and sum is rounded on its own, in the
// order of the numpy host tracker, so the three outputs equal the host
// tracker's bits.  Built with -fmad=false (see _build.py).
//
// Bound on an H100: the match MLP is the arithmetic, (H + e + 6) * M
// multiplies and as many adds per (row, column) pair plus M for the
// logit, 2 * 102 * 64 + 2 * 64 f32 operations a pair at full width, at
// 67 TFLOP/s outside the tensor cores (the pinned summation order rules
// out tensor cores).  The JV solve is sequential and outside that bound.
//
// Design: the TPU runs one grid cell per stream with everything in VMEM;
// here one block per stream would put the whole match MLP on one SM.  So
// a step is three launches on the caller's stream:
//   1. track_cost_kernel, grid (Q / kRows, K): each block computes the
//      detection features of every valid column into shared memory and the
//      h part of the first layer for its kRows rows (the first H terms of
//      the sequential sum depend on the row alone, so each row's partial
//      sum is computed once and each pair continues it over its e + 6
//      remaining terms), then one thread per (row, column) pair finishes
//      the layer, the logit and the cost.  Pairs with a dead row or a
//      padding column cost FORBIDDEN_DEVICE whatever their logit, so their
//      logits are not computed.
//   2. track_assign_kernel, one warp per stream: counts the live rows and
//      valid columns, solves the assoc_side square (jv.cuh) and writes the
//      solved column and the matched test per row.
//   3. track_gru_kernel, grid (2Q / kGruRows, K): the GRU of every row
//      against its solved column (h_upd) and of every column as a new
//      track (h_new), one thread per (row, hidden unit).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fastmath.cuh"
#include "jv.cuh"

namespace {

constexpr float kForbid = 8192.0f;        // hungarian.FORBIDDEN_DEVICE
constexpr float kHalfForbid = 4096.0f;
constexpr int kRows = 4;                  // slot rows per cost block
constexpr int kCostThreads = 128;
constexpr int kGruRows = 8;               // GRU rows per block
constexpr int kGruThreads = 128;

struct Slots {                            // per-stream operands, K-major
  const float* h_r;       // (K, Q, H)
  const float* tbox_r;    // (K, Q, 4)
  const float* alive_r;   // (K, Q)
  const float* te_gap_r;  // (K, Q)
  const float* te_match;  // (K, Q)
  const float* x;         // (K, Q, e)
  const float* dbox;      // (K, Q, 4)
  const float* dvalid;    // (K, Q)
};

struct Heads {                            // kernels/track_step PARAM_ORDER
  const float* dp_w;      // (e + 6, e)
  const float* dp_b;      // (e)
  const float* wz;        // (e + H, H)
  const float* wr;
  const float* wh;
  const float* bz;        // (H)
  const float* br;
  const float* bh;
  const float* m_w0;      // (H + e + 6, M)
  const float* m_b0;      // (M)
  const float* m_w1;      // (M, 1)
  const float* m_b1;      // (1)
  const float* table;     // log1p of integer gaps
  int n_table;
};

// detection feature j of one detection: tanh of the pinned dot of
// [x (e), box (4), te / 8, log1p(te)] with det_proj column j, plus bias
__device__ __forceinline__ float det_feat(const float* x, const float* box,
                                          float te, const Heads& P, int e,
                                          int j) {
  const float* w = P.dp_w + j;
  float acc = fm::dot(x, w, e, e);
  acc = fm::dot(box, w + e * e, 4, e, acc);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(te, 0.125f), w[(e + 4) * e]));
  acc = __fadd_rn(acc, __fmul_rn(fm::log1p_int(te, P.table, P.n_table),
                                 w[(e + 5) * e]));
  return fm::tanh(__fadd_rn(acc, P.dp_b[j]));
}

__global__ void __launch_bounds__(kCostThreads)
track_cost_kernel(Slots S, Heads P, const float* __restrict__ thr_p,
                  float* __restrict__ cost, int Q, int H, int e, int M) {
  extern __shared__ __align__(16) float sm[];
  const int fs = e + 1;                   // padded: no bank conflicts
  float* feats = sm;                      // (Q, fs) match-time features
  float* w0t = feats + Q * fs;            // (e + 6, M): m_w0 rows H..
  float* hpre = w0t + (e + 6) * M;        // (kRows, M): h part of layer 0
  const int k = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const float* alive = S.alive_r + (size_t)k * Q;
  const float* dvalid = S.dvalid + (size_t)k * Q;
  const float* te_m = S.te_match + (size_t)k * Q;
  const float* dbox = S.dbox + (size_t)k * Q * 4;
  const float* tbox = S.tbox_r + (size_t)k * Q * 4;
  const float* x = S.x + (size_t)k * Q * e;
  const float* h = S.h_r + (size_t)k * Q * H;
  float* out = cost + (size_t)k * Q * Q;

  bool any_live = false;
  for (int r = 0; r < kRows; ++r)
    any_live |= t0 + r < Q && alive[t0 + r] > 0.0f;
  if (!any_live) {                        // every pair of the tile forbidden
    for (int i = threadIdx.x; i < kRows * Q; i += blockDim.x) {
      const int t = t0 + i / Q;
      if (t < Q) out[(size_t)t * Q + i % Q] = kForbid;
    }
    return;
  }
  for (int i = threadIdx.x; i < (e + 6) * M; i += blockDim.x)
    w0t[i] = P.m_w0[(size_t)H * M + i];
  for (int i = threadIdx.x; i < Q * e; i += blockDim.x) {
    const int d = i / e, j = i % e;
    if (dvalid[d] > 0.0f)
      feats[d * fs + j] = det_feat(x + (size_t)d * e, dbox + d * 4, te_m[d],
                                   P, e, j);
  }
  for (int i = threadIdx.x; i < kRows * M; i += blockDim.x) {
    const int t = t0 + i / M, m = i % M;
    if (t < Q && alive[t] > 0.0f)
      hpre[i] = fm::dot(h + (size_t)t * H, P.m_w0 + m, H, M);
  }
  __syncthreads();

  const float thr = *thr_p;
  const float b1 = *P.m_b1;
  for (int i = threadIdx.x; i < kRows * Q; i += blockDim.x) {
    const int r = i / Q, d = i % Q, t = t0 + r;
    if (t >= Q) continue;
    float c = kForbid;
    if (alive[t] > 0.0f && dvalid[d] > 0.0f) {
      // relative features of detection d against track t
      const float* db = dbox + d * 4;
      const float* tb = tbox + t * 4;
      const float ts = fmaxf(te_m[d], 1.0f);
      float rel[6];
      rel[0] = __fsub_rn(db[0], tb[0]);
      rel[1] = __fsub_rn(db[1], tb[1]);
      rel[2] = __fdiv_rn(rel[0], ts);
      rel[3] = __fdiv_rn(rel[1], ts);
      rel[4] = __fsub_rn(db[2], tb[2]);
      rel[5] = __fsub_rn(db[3], tb[3]);
      const float* f = feats + d * fs;
      float logit = 0.0f;
      for (int m = 0; m < M; ++m) {
        // pair = [h (H), feats (e), rel (6)]: continue row t's h prefix
        float a = fm::dot(f, w0t + m, e, M, hpre[r * M + m]);
        a = fm::dot(rel, w0t + e * M + m, 6, M, a);
        const float hid = fm::tanh(__fadd_rn(a, P.m_b0[m]));
        logit = __fadd_rn(logit, __fmul_rn(hid, P.m_w1[m]));
      }
      const float prob = fm::sigmoid(__fadd_rn(logit, b1));
      c = prob >= thr ? __fsub_rn(1.0f, prob) : kForbid;
    }
    out[(size_t)t * Q + d] = c;
  }
}

__global__ void track_assign_kernel(const float* __restrict__ alive_r,
                                    const float* __restrict__ dvalid,
                                    const float* __restrict__ cost,
                                    int32_t* __restrict__ cols,
                                    int32_t* __restrict__ matched,
                                    int32_t* __restrict__ err, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* col_of = reinterpret_cast<int*>(smem);
  const jv::Scratch s = jv::carve(smem + (size_t)Q * sizeof(int), Q);
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const float* alive = alive_r + (size_t)k * Q;
  const float* valid = dvalid + (size_t)k * Q;
  const float* c = cost + (size_t)k * Q * Q;
  int t_cnt = 0, n_cnt = 0;
  for (int q = lane; q < Q; q += 32) {
    t_cnt += alive[q] > 0.0f;
    n_cnt += valid[q] > 0.0f;
  }
  t_cnt = __reduce_add_sync(jv::kFull, t_cnt);
  n_cnt = __reduce_add_sync(jv::kFull, n_cnt);
  // canonical assoc_side square: pow2 bucket of the counts, floor 8
  const int need = max(max(t_cnt, n_cnt), 8);
  int side = 8;
  for (int it = 0; it < 16; ++it)
    if (side < need) side *= 2;
  const bool ok = jv::solve_warp(c, Q, Q, min(side, Q), s, col_of);
  for (int t = lane; t < Q; t += 32) {
    const int j = col_of[t];
    cols[(size_t)k * Q + t] = j;
    matched[(size_t)k * Q + t] = c[(size_t)t * Q + j] < kHalfForbid ? j : -1;
  }
  if (!ok && lane == 0) atomicExch(err, 1);
}

__global__ void __launch_bounds__(kGruThreads)
track_gru_kernel(Slots S, Heads P, const int32_t* __restrict__ cols,
                 float* __restrict__ h_upd, float* __restrict__ h_new, int Q,
                 int H, int e) {
  extern __shared__ __align__(16) float sm[];
  float* feat = sm;                       // (kGruRows, e)
  float* hc = feat + kGruRows * e;        // (kGruRows, H) state
  float* z = hc + kGruRows * H;           // (kGruRows, H) update gate
  float* rh = z + kGruRows * H;           // (kGruRows, H) reset * state
  const int k = blockIdx.y;
  const int r0 = blockIdx.x * kGruRows;   // rows: [0, Q) h_upd, [Q, 2Q) h_new
  const int nr = min(kGruRows, 2 * Q - r0);
  const float* x = S.x + (size_t)k * Q * e;
  const float* dbox = S.dbox + (size_t)k * Q * 4;

  // row rho's detection, gap and state: a slot row against its solved
  // column (within-track gap, the track's h), or a column as a new track
  // (gap 0, h = 0)
  for (int i = threadIdx.x; i < nr * e; i += blockDim.x) {
    const int r = i / e, j = i % e, rho = r0 + r;
    int d;
    float te;
    if (rho < Q) {
      d = cols[(size_t)k * Q + rho];
      te = S.te_gap_r[(size_t)k * Q + rho];
    } else {
      d = rho - Q;
      te = 0.0f;
    }
    feat[r * e + j] = det_feat(x + (size_t)d * e, dbox + d * 4, te, P, e, j);
  }
  for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
    const int r = i / H, u = i % H, rho = r0 + r;
    hc[i] = rho < Q ? S.h_r[((size_t)k * Q + rho) * H + u] : 0.0f;
  }
  __syncthreads();
  // z and r over hf = [feat, h]
  for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
    const int r = i / H, u = i % H;
    float az = fm::dot(feat + r * e, P.wz + u, e, H);
    az = fm::dot(hc + r * H, P.wz + (size_t)e * H + u, H, H, az);
    float ar = fm::dot(feat + r * e, P.wr + u, e, H);
    ar = fm::dot(hc + r * H, P.wr + (size_t)e * H + u, H, H, ar);
    z[i] = fm::sigmoid(__fadd_rn(az, P.bz[u]));
    rh[i] = __fmul_rn(fm::sigmoid(__fadd_rn(ar, P.br[u])), hc[i]);
  }
  __syncthreads();
  // candidate over [feat, r * h], then the single-multiply blend
  for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
    const int r = i / H, u = i % H, rho = r0 + r;
    float ac = fm::dot(feat + r * e, P.wh + u, e, H);
    ac = fm::dot(rh + r * H, P.wh + (size_t)e * H + u, H, H, ac);
    const float cand = fm::tanh(__fadd_rn(ac, P.bh[u]));
    const float hv = hc[i];
    const float o = fm::fmadd(z[i], __fsub_rn(cand, hv), hv);
    if (rho < Q)
      h_upd[((size_t)k * Q + rho) * H + u] = o;
    else
      h_new[((size_t)k * Q + rho - Q) * H + u] = o;
  }
}

size_t cost_smem(int Q, int e, int M) {
  return sizeof(float) * ((size_t)Q * (e + 1) + (size_t)(e + 6) * M
                          + (size_t)kRows * M);
}

size_t assign_smem(int Q) {
  return (size_t)Q * sizeof(int) + jv::scratch_bytes(Q);
}

size_t gru_smem(int H, int e) {
  return sizeof(float) * (size_t)kGruRows * (e + 3 * H);
}

// opt a kernel in to more than the default 48 KB of dynamic shared memory
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int track_step_launch(
    const float* h_r, const float* tbox_r, const float* alive_r,
    const float* te_gap_r, const float* te_match, const float* x,
    const float* dbox, const float* dvalid, const float* thr,
    const float* dp_w, const float* dp_b, const float* wz, const float* wr,
    const float* wh, const float* bz, const float* br, const float* bh,
    const float* m_w0, const float* m_b0, const float* m_w1,
    const float* m_b1, const float* table, float* cost, int32_t* cols,
    int32_t* matched, float* h_upd, float* h_new, int32_t* err, int K,
    int Q, int H, int e, int M, int n_table, void* stream) {
  const Slots S{h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox, dvalid};
  const Heads P{dp_w, dp_b, wz, wr, wh, bz, br, bh,
                m_w0, m_b0, m_w1, m_b1, table, n_table};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc;
  const size_t sm1 = cost_smem(Q, e, M);
  if ((rc = allow_smem(track_cost_kernel, sm1)) != cudaSuccess) return rc;
  track_cost_kernel<<<dim3((Q + kRows - 1) / kRows, K), kCostThreads, sm1,
                      s>>>(S, P, thr, cost, Q, H, e, M);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const size_t sm2 = assign_smem(Q);
  if ((rc = allow_smem(track_assign_kernel, sm2)) != cudaSuccess) return rc;
  track_assign_kernel<<<K, 32, sm2, s>>>(alive_r, dvalid, cost, cols,
                                         matched, err, Q);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const size_t sm3 = gru_smem(H, e);
  if ((rc = allow_smem(track_gru_kernel, sm3)) != cudaSuccess) return rc;
  track_gru_kernel<<<dim3((2 * Q + kGruRows - 1) / kGruRows, K),
                     kGruThreads, sm3, s>>>(S, P, cols, h_upd, h_new, Q, H,
                                            e);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
