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
// tracker's bits.  Built with -fmad=false (see _build.py).  Parallelism
// runs across outputs that share no sum; no sum is split or reordered.
//
// Bound on an H100: the match MLP is the arithmetic, (H + e + 6) * M
// multiplies and as many adds per (row, column) pair plus M for the
// logit, 2 * 102 * 64 + 2 * 64 f32 operations a pair at full width, at
// 67 TFLOP/s outside the tensor cores (the pinned summation order rules
// out tensor cores).  The JV solve is sequential and outside that bound:
// its time is the latency of one step times the steps (jv.cuh).
//
// Design: the TPU runs one grid cell per stream with everything in VMEM;
// here one block per stream would put the whole match MLP on one SM.  So
// a step is four launches on the caller's stream:
//   1. track_feat_kernel, one thread per (stream, column, feature) and per
//      (stream, row, hidden unit): the match-time detection features of
//      each valid column, and the h part of the first match layer of each
//      live row (the first H terms of its sequential sum depend on the row
//      alone, so each pair continues it over its e + 6 remaining terms),
//      each computed once, into the workspace after the cost matrix.
//   2. track_cost_kernel, grid (Q / kPairRows, Q / kPairCols, K): a tile of
//      pairs a block, one thread per (pair, hidden unit) finishing that
//      unit's sum, then one thread per pair summing the logit over the
//      hidden units in order and writing the cost.  Pairs with a dead row
//      or a padding column cost FORBIDDEN_DEVICE whatever their logit, so
//      a tile without a live pair writes the sentinel and stops.
//   3. track_assign_kernel, one block per stream: counts the live rows and
//      valid columns, stages the assoc_side square into shared memory and
//      solves it with one warp (jv::solve_staged), then writes the solved
//      column and the matched test per row.  Q > jv::kRegMaxN (Q 512 and
//      up) takes track_assign_large_kernel (jv::solve_warp) instead, by Q
//      alone.
//   4. track_gru_kernel, grid (2Q / kGruRows, K): the GRU of every row
//      against its solved column (h_upd) and of every column as a new
//      track (h_new), one thread per (row, hidden unit).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fastmath.cuh"
#include "jv.cuh"

namespace {

constexpr float kForbid = 8192.0f;        // hungarian.FORBIDDEN_DEVICE
constexpr float kHalfForbid = 4096.0f;
constexpr int kFeatThreads = 128;
constexpr int kPairRows = 2;              // cost tile: rows x columns
constexpr int kPairCols = 8;
constexpr int kPairs = kPairRows * kPairCols;
constexpr int kCostThreads = 256;
constexpr int kAssignThreads = 256;       // stage the square, then one warp
constexpr int kGruRows = 2;               // GRU rows per block
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

// workspace: feats (K, Q, e) of the valid columns, then hpre (K, Q, M) of
// the live rows (other entries are never read)
__global__ void __launch_bounds__(kFeatThreads)
track_feat_kernel(Slots S, Heads P, float* __restrict__ feats,
                  float* __restrict__ hpre, int Q, int H, int e, int M) {
  const int k = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q * e) {
    const int d = i / e, j = i - d * e;
    if (S.dvalid[(size_t)k * Q + d] > 0.0f) {
      const size_t o = (size_t)k * Q + d;
      feats[o * e + j] = det_feat(S.x + o * e, S.dbox + o * 4,
                                  S.te_match[o], P, e, j);
    }
  } else if (i < Q * (e + M)) {
    const int t = (i - Q * e) / M, m = (i - Q * e) - t * M;
    if (S.alive_r[(size_t)k * Q + t] > 0.0f) {
      const size_t o = (size_t)k * Q + t;
      hpre[o * M + m] = fm::dot(S.h_r + o * H, P.m_w0 + m, H, M);
    }
  }
}

__global__ void __launch_bounds__(kCostThreads)
track_cost_kernel(Slots S, Heads P, const float* __restrict__ feats,
                  const float* __restrict__ hpre,
                  const float* __restrict__ thr_p, float* __restrict__ cost,
                  int Q, int H, int e, int M) {
  extern __shared__ __align__(16) float sm[];
  float* rel = sm;                        // (kPairs, 6) relative features
  float* hid = rel + kPairs * 6;          // (kPairs, M + 1): padded rows
  const int k = blockIdx.z;
  const int t0 = blockIdx.x * kPairRows;
  const int d0 = blockIdx.y * kPairCols;
  const float* alive = S.alive_r + (size_t)k * Q;
  const float* dvalid = S.dvalid + (size_t)k * Q;
  float* out = cost + (size_t)k * Q * Q;

  bool any_row = false, any_col = false;
  for (int r = 0; r < kPairRows; ++r)
    any_row |= t0 + r < Q && alive[t0 + r] > 0.0f;
  for (int c = 0; c < kPairCols; ++c)
    any_col |= d0 + c < Q && dvalid[d0 + c] > 0.0f;
  if (!any_row || !any_col) {             // every pair of the tile forbidden
    for (int p = threadIdx.x; p < kPairs; p += blockDim.x) {
      const int t = t0 + p / kPairCols, d = d0 + p % kPairCols;
      if (t < Q && d < Q) out[(size_t)t * Q + d] = kForbid;
    }
    return;
  }
  // relative features of detection d against track t
  const float* dbox = S.dbox + (size_t)k * Q * 4;
  const float* tbox = S.tbox_r + (size_t)k * Q * 4;
  const float* te_m = S.te_match + (size_t)k * Q;
  if (threadIdx.x < kPairs) {
    const int p = threadIdx.x;
    const int t = min(t0 + p / kPairCols, Q - 1);
    const int d = min(d0 + p % kPairCols, Q - 1);
    const float* db = dbox + d * 4;
    const float* tb = tbox + t * 4;
    const float ts = fmaxf(te_m[d], 1.0f);
    float* r = rel + p * 6;
    r[0] = __fsub_rn(db[0], tb[0]);
    r[1] = __fsub_rn(db[1], tb[1]);
    r[2] = __fdiv_rn(r[0], ts);
    r[3] = __fdiv_rn(r[1], ts);
    r[4] = __fsub_rn(db[2], tb[2]);
    r[5] = __fsub_rn(db[3], tb[3]);
  }
  __syncthreads();
  // hidden unit m of pair p: row t's h prefix, continued over the
  // column's features (e) and the pair's relative features (6)
  const float* w0f = P.m_w0 + (size_t)H * M;
  const float* w0r = P.m_w0 + (size_t)(H + e) * M;
  for (int i = threadIdx.x; i < kPairs * M; i += blockDim.x) {
    const int p = i / M, m = i - p * M;
    const int t = t0 + p / kPairCols, d = d0 + p % kPairCols;
    if (t >= Q || d >= Q || !(alive[t] > 0.0f) || !(dvalid[d] > 0.0f))
      continue;
    const size_t ot = (size_t)k * Q + t, od = (size_t)k * Q + d;
    float a = fm::dot(feats + od * e, w0f + m, e, M, hpre[ot * M + m]);
    a = fm::dot(rel + p * 6, w0r + m, 6, M, a);
    hid[p * (M + 1) + m] = fm::tanh(__fadd_rn(a, P.m_b0[m]));
  }
  __syncthreads();
  if (threadIdx.x < kPairs) {
    const int p = threadIdx.x;
    const int t = t0 + p / kPairCols, d = d0 + p % kPairCols;
    if (t < Q && d < Q) {
      float c = kForbid;
      if (alive[t] > 0.0f && dvalid[d] > 0.0f) {
        float logit = 0.0f;               // the logit's sum, in order
        for (int m = 0; m < M; ++m)
          logit = __fadd_rn(logit, __fmul_rn(hid[p * (M + 1) + m],
                                             P.m_w1[m]));
        const float prob = fm::sigmoid(__fadd_rn(logit, *P.m_b1));
        c = prob >= *thr_p ? __fsub_rn(1.0f, prob) : kForbid;
      }
      out[(size_t)t * Q + d] = c;
    }
  }
}

// the canonical assoc_side square of one stream: the pow2 bucket of its
// live-row and valid-column counts, floor 8, at most Q (one warp)
__device__ inline int assoc_side(const float* alive, const float* valid,
                                 int Q) {
  const int lane = threadIdx.x & 31;
  int t_cnt = 0, n_cnt = 0;
  for (int q = lane; q < Q; q += 32) {
    t_cnt += alive[q] > 0.0f;
    n_cnt += valid[q] > 0.0f;
  }
  t_cnt = __reduce_add_sync(jv::kFull, t_cnt);
  n_cnt = __reduce_add_sync(jv::kFull, n_cnt);
  const int need = max(max(t_cnt, n_cnt), 8);
  int side = 8;
  for (int it = 0; it < 16; ++it)
    if (side < need) side *= 2;
  return min(side, Q);
}

// the solved column and the matched test per row, from col_of (one warp)
__device__ inline void write_rows(const int* col_of, const float* c, int Q,
                                  int32_t* cols, int32_t* matched) {
  for (int t = threadIdx.x & 31; t < Q; t += 32) {
    const int j = col_of[t];
    cols[t] = j;
    matched[t] = c[(size_t)t * Q + j] < kHalfForbid ? j : -1;
  }
}

__global__ void __launch_bounds__(kAssignThreads)
track_assign_kernel(const float* __restrict__ alive_r,
                    const float* __restrict__ dvalid,
                    const float* __restrict__ cost,
                    int32_t* __restrict__ cols,
                    int32_t* __restrict__ matched,
                    int32_t* __restrict__ err, int Q, size_t stage_bytes) {
  extern __shared__ __align__(16) float cs[];   // the square, then Q ints
  __shared__ int side_s;
  const int k = blockIdx.x;
  const float* c = cost + (size_t)k * Q * Q;
  if (threadIdx.x < 32) {
    const int side = assoc_side(alive_r + (size_t)k * Q,
                                dvalid + (size_t)k * Q, Q);
    if (threadIdx.x == 0) side_s = side;
  }
  __syncthreads();
  const int side = side_s;
  const jv::Square sq = jv::stage_square(c, Q, side, stage_bytes, cs);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  int* col_of = reinterpret_cast<int*>(cs + stage_bytes / sizeof(float));
  const bool ok = jv::solve_staged(sq, side, Q, col_of);
  write_rows(col_of, c, Q, cols + (size_t)k * Q, matched + (size_t)k * Q);
  if (!ok && threadIdx.x == 0) atomicOr(err, 1);
}

__global__ void track_assign_large_kernel(const float* __restrict__ alive_r,
                                          const float* __restrict__ dvalid,
                                          const float* __restrict__ cost,
                                          int32_t* __restrict__ cols,
                                          int32_t* __restrict__ matched,
                                          int32_t* __restrict__ err, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* col_of = reinterpret_cast<int*>(smem);
  const jv::Scratch s = jv::carve(smem + (size_t)Q * sizeof(int), Q);
  const int k = blockIdx.x;
  const float* c = cost + (size_t)k * Q * Q;
  const int side = assoc_side(alive_r + (size_t)k * Q,
                              dvalid + (size_t)k * Q, Q);
  const bool ok = jv::solve_warp(c, Q, Q, side, s, col_of);
  write_rows(col_of, c, Q, cols + (size_t)k * Q, matched + (size_t)k * Q);
  if (!ok && threadIdx.x == 0) atomicOr(err, 1);
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

size_t cost_smem(int M) {
  return sizeof(float) * ((size_t)kPairs * 6 + (size_t)kPairs * (M + 1));
}

size_t assign_smem(int Q) {
  return jv::square_bytes(Q) + (size_t)Q * sizeof(int);
}

size_t assign_large_smem(int Q) {
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

// cost: the (K, Q, Q) cost matrices followed by the workspace, K * Q *
// (e + M) floats (track_feat_kernel's features and h prefixes)
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
  float* feats = cost + (size_t)K * Q * Q;
  float* hpre = feats + (size_t)K * Q * e;
  track_feat_kernel<<<dim3((Q * (e + M) + kFeatThreads - 1) / kFeatThreads,
                           K), kFeatThreads, 0, s>>>(S, P, feats, hpre, Q,
                                                     H, e, M);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const size_t sm1 = cost_smem(M);
  if ((rc = allow_smem(track_cost_kernel, sm1)) != cudaSuccess) return rc;
  track_cost_kernel<<<dim3((Q + kPairRows - 1) / kPairRows,
                           (Q + kPairCols - 1) / kPairCols, K),
                      kCostThreads, sm1, s>>>(S, P, feats, hpre, thr, cost,
                                              Q, H, e, M);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  if (Q <= jv::kRegMaxN) {
    const size_t sm2 = assign_smem(Q);
    if ((rc = allow_smem(track_assign_kernel, sm2)) != cudaSuccess)
      return rc;
    track_assign_kernel<<<K, kAssignThreads, sm2, s>>>(
        alive_r, dvalid, cost, cols, matched, err, Q, jv::square_bytes(Q));
  } else {
    const size_t sm2 = assign_large_smem(Q);
    if ((rc = allow_smem(track_assign_large_kernel, sm2)) != cudaSuccess)
      return rc;
    track_assign_large_kernel<<<K, 32, sm2, s>>>(alive_r, dvalid, cost,
                                                 cols, matched, err, Q);
  }
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
