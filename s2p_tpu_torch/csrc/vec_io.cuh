// 16-byte vector loads and stores of f32 and bf16 channels, converted to and
// from f32 registers: V = 4 f32 or 8 bf16 channels a thread, or V = 1 (the
// scalar variant). Shared by the port's hand kernels (fused_mat_norm.cu,
// spade_norm.cu); the caller guarantees 16-byte alignment when V > 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>) f[0] = *p;
    else f[0] = __bfloat162float(*p);
  } else if constexpr (std::is_same_v<T, float>) {
    static_assert(V == 4, "16 bytes of f32");
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  } else {
    static_assert(V == 8, "16 bytes of bf16");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>) *p = f[0];
    else *p = __float2bfloat16_rn(f[0]);
  } else if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
}
