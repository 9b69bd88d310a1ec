// Shared helpers of the hand-written Hopper kernels: storage-type
// conversions and the dropout position hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes of the C interface (the Python wrappers pass these)
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kF16 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// x rounded to the storage type T and widened back (round half to even,
// as torch's .to(bfloat16/float16) and jnp's astype do)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The stateless dropout mask of paddle_tpu/ops/pallas.py:_hash_keep
// (murmur3 fmix32 over the score position), in native uint32: the JAX
// kernel's int32 wraparound multiplies and logical shifts are exactly
// these uint32 operations, so the keep mask is bit-identical.
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t bh, uint32_t qpos,
                                          uint32_t kpos, uint32_t thresh) {
  uint32_t u = (qpos * 0x9E3779B1u) ^ (kpos * 0x85EBCA77u) ^ (seed + bh * 0x27D4EB2Fu);
  u ^= u >> 16;
  u *= 0x85EBCA6Bu;
  u ^= u >> 13;
  u *= 0xC2B2AE35u;
  u ^= u >> 16;
  return (u & ((1u << 23) - 1u)) < thresh;
}

}  // namespace ptt
