// Fused proxy plan: head matvec + bias, sigmoid, threshold, span map
// onto the detector grid, and per-frame plan stats.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/proxy_plan/kernel.py::proxy_plan_pallas
//   (body _plan_kernel).
//
// Bound on an H100: at the main path's shapes (feat (16, 8, 13, 64) f32
// -> grid (16, 34, 60) int8 + stats (16, 8) int32) the call moves about
// 0.46 MB and does about 0.2 MFLOP, so the card could finish it in well
// under a microsecond: it is bound by latency, the chain of dependent
// memory round trips and barriers inside one block, far below both the
// memory and the arithmetic line.  The design keeps that chain to one
// round trip from device memory and a few phases in shared memory:
//
//   * one block of kThreads = 512 per frame; its thread 0 asks for the
//     frame's features (one contiguous run, 26,624 bytes at the main
//     path), w and both span matrices in ONE wave of 1-D bulk copies
//     into shared memory, completing on one mbarrier, before anything is
//     used.  A bulk copy needs 16-byte aligned addresses and sizes;
//     shapes that miss that (an odd C, a span matrix of 60 bytes as the
//     reduced config's), or whose features would not fit, take the
//     branch of ordinary loads: the head reads the features from device
//     memory (float4 when C is a multiple of 4 and the rows aligned, else
//     scalar) and the span rows are read where they lie.  Both branches
//     do the same arithmetic;
//   * the head: kGroup = 4 threads per proxy cell (128 cells a pass: the
//     main path's 104 in one), lane j of a group taking the channel quads
//     q = j, j + 4, ... (channels 4q .. 4q + 3 in order, one fmaf each),
//     then a butterfly over the group's 4 lanes (xor 2, 1), so lane 0
//     holds (v0 + v2) + (v1 + v3) and the others the same sum, since f32
//     addition commutes;
//   * the mapping, through bitmasks: a proxy row's positives are a word
//     of bits over the proxy columns, each span row a word of bits over
//     its sources (nonzero entries).  A detector row's word is the OR of
//     the proxy rows its span covers, and cell (y, x) is mapped iff that
//     word AND span_x row x's word is nonzero.  This is exact for the
//     op's contract, 0/1 span matrices: "any positive under a span" is
//     what the reference's count > 0.5 computes.  Nothing returns to
//     device memory inside a loop;
//   * the grid is written four cells to a 32-bit store where a frame's
//     cell count allows it, and the stats reduce through warp reductions
//     and shared-memory atomics.
//
// Measured on the card (PERF.md): this design at 512 threads and
// 4 lanes a cell read faster than at 256 or 1024 threads or 8 lanes,
// than a cluster of 2 or 4 blocks per frame splitting the detector rows
// (stats over distributed shared memory), than per-detector-row words
// of the detector columns, and as fast as 16-byte cp.async staging.
//
// Numerics: the logit is a 64-term dot in the order above (not the
// reference's), and the sigmoid is 1 / (1 + expf(-x)) with the accurate
// expf and an IEEE divide (no fast math), held to the strict
// s > threshold.  A cell whose sigmoid sits within a few ulp of the
// threshold can therefore flip against the plain version; the tests and
// chip_smoke.py count such flips and check that each one lies within
// that band.  The mapping and stats are exact given the positives.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 4;   // threads per proxy cell in the head
constexpr int kStatsW = 8;  // [count, ymin, ymax, xmin, xmax, 0, 0, 0]
// shared memory: the staged inputs of the bulk branch, then the masks
constexpr int kMaxStaged = 40 * 1024;
constexpr int kMaxMasks = 7 * 1024;  // both within 48 KB with the static

__host__ __device__ inline int words(int bits) { return (bits + 31) / 32; }

// bytes of the bitmask words: rows' positives (hp x nwx), span_y rows
// (hc x nwy), span_x rows (wc x nwx), detector rows (hc x nwx)
__host__ __device__ inline int mask_bytes(int hp, int wp, int hc, int wc) {
  const int nwx = words(wp), nwy = words(hp);
  return (hp * nwx + hc * nwy + wc * nwx + hc * nwx) * 4;
}

// bytes of the staged inputs: a frame's features, w, span_y, span_x
__host__ __device__ inline int staged_bytes(int hp, int wp, int C, int hc,
                                            int wc) {
  return (hp * wp * C + C + hc * hp + wc * wp) * 4;
}

template <bool kBulk, bool kVec4>
__global__ void __launch_bounds__(kThreads) proxy_plan_kernel(
    const float* __restrict__ feat,    // (B, hp, wp, C)
    const float* __restrict__ w,       // (C,)
    const float* __restrict__ b,       // (1,)
    float threshold,
    const float* __restrict__ span_y,  // (hc, hp) 0/1
    const float* __restrict__ span_x,  // (wc, wp) 0/1
    int8_t* __restrict__ grid,         // (B, hc, wc)
    int32_t* __restrict__ stats,       // (B, kStatsW)
    int hp, int wp, int C, int hc, int wc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  __shared__ int s_count, s_ymin, s_ymax, s_xmin, s_xmax;

  const int tid = threadIdx.x;
  const int frame = blockIdx.x;
  const int n_cells = hp * wp;
  const int nwx = words(wp), nwy = words(hp);
  const float* f = feat + (size_t)frame * n_cells * C;
  const float* fs = f;
  const float* ws = w;
  const float* sys = span_y;
  const float* sxs = span_x;
  int staged = 0;
  if (kBulk) {
    float* st = reinterpret_cast<float*>(smem);
    fs = st;
    ws = st + n_cells * C;
    sys = ws + C;
    sxs = sys + hc * hp;
    staged = staged_bytes(hp, wp, C, hc, wc);
    if (tid == 0) {
      hopper::mbar_init(&bar, 1);
      hopper::fence_barrier_init();
      hopper::mbar_expect_tx(&bar, staged);
      hopper::bulk_load(st, f, n_cells * C * 4, &bar);
      hopper::bulk_load(st + n_cells * C, w, C * 4, &bar);
      hopper::bulk_load(st + n_cells * C + C, span_y, hc * hp * 4, &bar);
      hopper::bulk_load(st + n_cells * C + C + hc * hp, span_x,
                        wc * wp * 4, &bar);
    }
  }
  uint32_t* rowbits = reinterpret_cast<uint32_t*>(smem + staged);
  uint32_t* ymask = rowbits + hp * nwx;  // span_y rows over proxy rows
  uint32_t* xmask = ymask + hc * nwy;    // span_x rows over proxy columns
  uint32_t* rmask = xmask + wc * nwx;    // detector rows over proxy columns
  // while the copies fly: clear the positives, set the stats' sentinels
  for (int i = tid; i < hp * nwx; i += kThreads) rowbits[i] = 0;
  if (tid == 0) {
    s_count = 0;
    s_ymin = hc;
    s_ymax = -1;
    s_xmin = wc;
    s_xmax = -1;
  }
  const float bias = b[0];
  __syncthreads();  // the barrier's init and the cleared words
  if (kBulk) hopper::mbar_wait(&bar, 0);

  // 1. span rows as bitmasks of their nonzero entries
  for (int i = tid; i < hc * nwy + wc * nwx; i += kThreads) {
    const bool is_y = i < hc * nwy;
    const int j = is_y ? i : i - hc * nwy;
    const int nw = is_y ? nwy : nwx;
    const int n_src = is_y ? hp : wp;
    const int row = j / nw, k = j - (j / nw) * nw;
    const float* src = (is_y ? sys : sxs) + row * n_src;
    uint32_t word = 0;
    for (int bit = 0; bit < 32 && 32 * k + bit < n_src; ++bit)
      if (src[32 * k + bit] != 0.f) word |= 1u << bit;
    (is_y ? ymask : xmask)[j] = word;
  }

  // 2. the head: kGroup threads a cell; the loop's trip count is the
  // same for every thread, so each shuffle has the whole warp
  const int lane_g = tid % kGroup;
  const int n_quads = (C + 3) / 4;
  for (int base = 0; base < n_cells; base += kThreads / kGroup) {
    const int cell = base + tid / kGroup;
    float acc = 0.f;
    if (cell < n_cells) {
      const float* fc = fs + (size_t)cell * C;
      for (int q = lane_g; q < n_quads; q += kGroup) {
        if (kVec4) {
          const float4 a = reinterpret_cast<const float4*>(fc)[q];
          const float4 v = reinterpret_cast<const float4*>(ws)[q];
          acc = fmaf(a.x, v.x, acc);
          acc = fmaf(a.y, v.y, acc);
          acc = fmaf(a.z, v.z, acc);
          acc = fmaf(a.w, v.w, acc);
        } else {
          for (int c = 4 * q; c < 4 * q + 4 && c < C; ++c)
            acc = fmaf(fc[c], ws[c], acc);
        }
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane_g == 0 && cell < n_cells) {
      const float s = 1.0f / (1.0f + expf(-(acc + bias)));
      if (s > threshold) {
        const int h = cell / wp, xp = cell - (cell / wp) * wp;
        atomicOr(&rowbits[h * nwx + xp / 32], 1u << (xp % 32));
      }
    }
  }
  __syncthreads();

  // 3. detector rows: OR of the positives of the proxy rows under the span
  for (int i = tid; i < hc * nwx; i += kThreads) {
    const int y = i / nwx, k = i - (i / nwx) * nwx;
    uint32_t word = 0;
    for (int kk = 0; kk < nwy; ++kk)
      for (uint32_t m = ymask[y * nwy + kk]; m; m &= m - 1)
        word |= rowbits[(32 * kk + __ffs(m) - 1) * nwx + k];
    rmask[i] = word;
  }
  __syncthreads();

  // 4. the grid, and the stats over it
  int count = 0, ymin = hc, ymax = -1, xmin = wc, xmax = -1;
  const int n_out = hc * wc;
  int8_t* g = grid + (size_t)frame * n_out;
  // four cells a store where every frame starts on 4 bytes
  const bool packed =
      n_out % 4 == 0 && (reinterpret_cast<uintptr_t>(grid) & 3) == 0;
  for (int q = tid; q < (n_out + 3) / 4; q += kThreads) {
    uint32_t out = 0;
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * q + e;
      if (i >= n_out) break;
      const int y = i / wc, x = i - (i / wc) * wc;
      bool mapped = false;
      for (int k = 0; k < nwx; ++k)
        mapped |= (rmask[y * nwx + k] & xmask[x * nwx + k]) != 0;
      if (mapped) {
        ++count;
        ymin = min(ymin, y);
        ymax = max(ymax, y);
        xmin = min(xmin, x);
        xmax = max(xmax, x);
        out |= 1u << (8 * e);
      }
      if (!packed) g[i] = mapped ? 1 : 0;
    }
    if (packed) reinterpret_cast<uint32_t*>(g)[q] = out;
  }
  count = __reduce_add_sync(0xffffffffu, count);
  ymin = __reduce_min_sync(0xffffffffu, ymin);
  ymax = __reduce_max_sync(0xffffffffu, ymax);
  xmin = __reduce_min_sync(0xffffffffu, xmin);
  xmax = __reduce_max_sync(0xffffffffu, xmax);
  if (tid % 32 == 0) {
    atomicAdd(&s_count, count);
    atomicMin(&s_ymin, ymin);
    atomicMax(&s_ymax, ymax);
    atomicMin(&s_xmin, xmin);
    atomicMax(&s_xmax, xmax);
  }
  __syncthreads();
  if (tid < kStatsW) {
    const int v[kStatsW] = {s_count, s_ymin, s_ymax, s_xmin, s_xmax,
                            0,       0,      0};
    stats[(size_t)frame * kStatsW + tid] = v[tid];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int proxy_plan_launch(const float* feat, const float* w,
                                 const float* b, float threshold,
                                 const float* span_y, const float* span_x,
                                 int8_t* grid, int32_t* stats, int B, int hp,
                                 int wp, int C, int hc, int wc,
                                 void* stream) {
  const int masks = mask_bytes(hp, wp, hc, wc);
  if (masks > kMaxMasks) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = C % 4 == 0 && aligned16(feat) && aligned16(w);
  const int staged = staged_bytes(hp, wp, C, hc, wc);
  const bool bulk = vec4 && aligned16(span_y) && aligned16(span_x) &&
                    (hc * hp * 4) % 16 == 0 && (wc * wp * 4) % 16 == 0 &&
                    staged <= kMaxStaged;
  if (bulk)
    proxy_plan_kernel<true, true><<<B, kThreads, staged + masks, s>>>(
        feat, w, b, threshold, span_y, span_x, grid, stats, hp, wp, C, hc,
        wc);
  else if (vec4)
    proxy_plan_kernel<false, true><<<B, kThreads, masks, s>>>(
        feat, w, b, threshold, span_y, span_x, grid, stats, hp, wp, C, hc,
        wc);
  else
    proxy_plan_kernel<false, false><<<B, kThreads, masks, s>>>(
        feat, w, b, threshold, span_y, span_x, grid, stats, hp, wp, C, hc,
        wc);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
