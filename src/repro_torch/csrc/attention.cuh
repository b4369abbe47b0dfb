// Loads and stores shared by the attention kernels (flash_attention.cu,
// decode_attention.cu) and ssd_scan.cu: inputs are f32 or bf16,
// converted to f32 on load (16 bytes at a time through Ld); outputs are
// rounded to nearest-even when bf16, as torch's .to(torch.bfloat16)
// rounds in the plain versions.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace attn {

// the reference's mask value, jnp.finfo(jnp.float32).min
constexpr float kNegInf = -FLT_MAX;

template <typename T>
struct Ld;

template <>
struct Ld<float> {
  static constexpr int N = 4;  // elements in 16 bytes
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <>
struct Ld<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace attn
