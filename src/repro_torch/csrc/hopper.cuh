// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile
// loads, 1-D bulk loads, wgmma shared-memory descriptors, the
// m64n64k16 / m64n128k16 bf16 products and the m64n64k8 / m64n128k8 tf32
// products with f32 accumulators; on the host, bf16 and f32 TMA tensor
// maps (cached).  Used by flash_attention.cu and ssd_scan.cu;
// proxy_plan.cu uses the mbarriers and the bulk loads.
//
// Register layout of an m64nN f32 accumulator d[N / 2] (PTX ISA, wgmma
// "register fragment" figures): warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; lane l holds, for each 8-column block j, d[4 j + e]
// at row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2.  An A
// operand from registers (m64k16, four 32-bit registers of two bf16 each)
// has the same layout over 16 columns: a[0] row l / 4, columns 2 (l % 4)
// + {0, 1}; a[1] row + 8; a[2] columns + 8; a[3] both.  So an m64n64
// accumulator's d[8 kk .. 8 kk + 7], packed in pairs, is the A operand of
// columns 16 kk .. 16 kk + 15.
//
// A tf32 A operand from registers (m64k8, four 32-bit registers) holds
// a[0] at row l / 4, column l % 4; a[1] row + 8; a[2] column + 4; a[3]
// both.  An accumulator's 8-column block j holds columns 2 (l % 4) and
// 2 (l % 4) + 1 instead, so (d[4 j], d[4 j + 2], d[4 j + 1], d[4 j + 3])
// is the A operand of block j with its K order permuted: logical k holds
// column kPermK[k] = (0, 2, 4, 6, 1, 3, 5, 7)[k].  The B operand's K rows
// are written in that order to match (tf32_k_slot gives a column's slot,
// tf32_k_col a slot's column).
// tf32 operands must be K-major in shared memory (wgmma has no transpose
// for them), and the tensor cores read an f32 word's top 19 bits (sign,
// exponent, 10 mantissa bits): tf32 by truncation.  3xTF32 ("fast f32")
// splits v into hi = trunc(v) and lo = v - hi (exact) and sums hi hi' +
// hi lo' + lo hi' in one f32 accumulator, about f32 accuracy.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive, and expect ``bytes`` more to land through complete_tx
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 4-D box of a tensor map into shared memory (coordinates innermost
// first); elements out of bounds land as zeros, and the barrier counts
// the whole box's bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same for a 3-D box
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a 1-D bulk copy of ``bytes`` from global into shared memory (both
// addresses 16-byte aligned, ``bytes`` a multiple of 16); the barrier
// counts the bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// make this thread's ordinary shared-memory writes visible to the async
// proxy (a wgmma reading them as an operand); then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a barrier of the ``count`` threads (a multiple of 32) that name ``id``
// (1-15: 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// A wgmma shared-memory descriptor for a tile in the 128-byte swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes (rows of 128 bytes, atoms
// of 8 rows, the tile 1024-byte aligned): start address, leading and
// stride byte offsets (each >> 4), layout type 1 (128B swizzle).  Adding
// n to the descriptor moves its start by 16 n bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile,
                                               uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// wait until at most ``N`` committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64n64, f32) = (scale_d ? d : 0) + A B, A (64 x 16) and B (16 x 64)
// bf16 from shared memory, by default both K-major (A's rows and B's
// columns hold their 16 K values contiguous); TransA: A is M-major (its
// columns hold their 64 M values contiguous), TransB: B is N-major
template <int TransA = 0, int TransB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// d (m64n128, f32) = (scale_d ? d : 0) + A B, A (64 x 16) and B (16 x 128)
// bf16 from shared memory, both K-major
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n64, f32) += A B, A (64 x 16) bf16 from registers (a0..a3, the
// layout above), B (16 x 64) bf16 from shared memory, MN-major (B's rows
// hold their 64 N values contiguous: trans-b)
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      uint32_t a0,
                                                      uint32_t a1,
                                                      uint32_t a2,
                                                      uint32_t a3,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// tf32 (3xTF32): the truncation the tensor cores apply, and the rest
__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
}
__device__ __forceinline__ float tf32_lo(float v) {
  return v - tf32_trunc(v);                    // exact in f32
}
// the slot, within its group of 8, of K column c in the permuted K order
// of an A operand taken from an accumulator (above): 0 2 4 6 1 3 5 7 ->
// 0 1 2 3 4 5 6 7
__device__ __forceinline__ int tf32_k_slot(int c) {
  return (c & ~7) | ((c & 1) << 2) | ((c & 7) >> 1);
}
// and its inverse: the column K slot s holds (0 1 2 3 4 5 6 7 -> 0 2 4 6
// 1 3 5 7)
__device__ __forceinline__ int tf32_k_col(int s) {
  return (s & ~7) | ((s & 3) << 1) | ((s >> 2) & 1);
}
// byte offset of 32-bit element k (0..31) of row r in a tile of 128-byte
// rows in the 128-byte swizzle (16-byte chunk k / 4 at k / 4 ^ r % 8)
__device__ __forceinline__ int sw128_f32(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}
__device__ __forceinline__ float4 tf32_lo4(float4 v) {
  return make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
}

// the descriptor of 8-wide K step kk of a K-major tf32 operand: a tile of
// 32-float panels (rows of 128 bytes, 128-byte swizzle) ``panel`` bytes
// apart; a step is 32 bytes (+2)
__device__ __forceinline__ uint64_t desc_tf32_k(const void* tile, int kk,
                                                int panel) {
  return desc_sw128(static_cast<const unsigned char*>(tile)
                    + (kk >> 2) * panel, 16, 1024) + 2 * (kk & 3);
}

// d (m64n64, f32) = (scale_d ? d : 0) + A B, A (64 x 8) and B (8 x 64)
// tf32 from shared memory, both K-major (8 K values, 32 bytes, of a row
// contiguous)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n128, f32) = (scale_d ? d : 0) + A B, tf32 from shared memory,
// both K-major
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64],
                                                        uint64_t desc_a,
                                                        uint64_t desc_b,
                                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n64, f32) += A B, A (64 x 8) tf32 from registers (a0..a3, the
// layout above), B (8 x 64) tf32 from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                       float a0, float a1,
                                                       float a2, float a3,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)), "l"(desc_b),
        "r"(1));
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kMaxRank = 5;

// A tensor map over a bf16 or f32 tensor (``type``) of ``rank``
// dimensions (dims[0] innermost and contiguous; strides[i], in bytes,
// between steps of dims[i + 1]), boxes of ``box`` elements in the
// 128-byte swizzle (the box's innermost extent at most 128 bytes: 64 bf16
// or 32 f32); elements out of bounds land as zeros.  The last kMaps maps
// are kept, keyed by everything they encode: a map depends only on the
// address, the type and the shape, so a call on the same tensors (or on
// new ones the caching allocator put at the same addresses) skips
// cuTensorMapEncodeTiled, microseconds of the host time a call costs.  Calls
// may come from several threads (ctypes drops the GIL): a mutex guards
// the entries.
inline bool tiled_tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                             const void* ptr, int rank,
                             const cuuint64_t* dims,
                             const cuuint64_t* strides,
                             const cuuint32_t* box) {
  constexpr int kMaps = 16;
  struct Key {
    const void* ptr;
    int type, rank;
    cuuint64_t dims[kMaxRank], strides[kMaxRank];
    cuuint32_t box[kMaxRank];
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  if (rank < 1 || rank > kMaxRank) return false;
  Key key;
  memset(&key, 0, sizeof(key));
  key.ptr = ptr;
  key.type = (int)type;
  key.rank = rank;
  memcpy(key.dims, dims, rank * sizeof(cuuint64_t));
  memcpy(key.strides, strides, (rank - 1) * sizeof(cuuint64_t));
  memcpy(key.box, box, rank * sizeof(cuuint32_t));
  static Entry cache[kMaps] = {};
  static int next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.key.rank && memcmp(&e.key, &key, sizeof(key)) == 0) {
      *map = e.map;
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t elem[kMaxRank] = {1, 1, 1, 1, 1};
  if (encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = Entry{key, *map};
  next = (next + 1) % kMaps;
  return true;
}

inline bool bf16_tensor_map(CUtensorMap* map, const void* ptr, int rank,
                            const cuuint64_t* dims,
                            const cuuint64_t* strides,
                            const cuuint32_t* box) {
  return tiled_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank,
                          dims, strides, box);
}

inline bool f32_tensor_map(CUtensorMap* map, const void* ptr, int rank,
                           const cuuint64_t* dims,
                           const cuuint64_t* strides,
                           const cuuint32_t* box) {
  return tiled_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, rank,
                          dims, strides, box);
}

}  // namespace hopper
