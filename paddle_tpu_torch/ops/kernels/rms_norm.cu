// RMSNorm forward over rows for Hopper (sm_90a).
//
// Replaces: paddle_tpu/incubate/nn/functional/__init__.py
// `_rms_norm_pallas_fwd_impl` (pallas_call at :88; entry `fused_rms_norm`
// :101): out = x * rsqrt(mean(x^2) + eps) * w (+ b), computed in f32 and
// cast to x's type. The backward recomputes through the plain version, as
// the JAX package's custom_vjp does (:57-63), so there is no backward
// kernel.
//
// Design. The TPU kernel takes 256-row blocks through VMEM. Here one CTA
// of 256 threads takes one row: each thread sums the squares of its
// 16-byte packs of the row in f32, a warp-shuffle and shared-memory
// reduction gives the row's sum, and a second pass over the row (mostly
// served from L1/L2) writes the output in 16-byte packs. Any number of
// rows; D must be a multiple of 8 so that a row is a whole number of
// 16-byte packs in f32 and in bf16 (the wrapper checks it and the
// alignment).
//
// Bound on this card: bytes (read x once, write out once, ~4 flops per
// element). At the Llama-3-8B width (R = 4096 tokens, D = 4096, bf16) that
// is 67 MB, 0.02 ms at 3.35 TB/s. One row per CTA leaves each SM with few
// bytes in flight per thread for a 4096-wide bf16 row (two 16-byte packs
// per thread); several rows per CTA and loads issued ahead of the
// reduction are what this first kernel leaves on the table.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rms_norm_kernel(const T* __restrict__ x,
                                                      const W* __restrict__ w,
                                                      const W* __restrict__ bias,
                                                      T* __restrict__ out, int D, float eps) {
  constexpr int PACK = 16 / sizeof(T);
  __shared__ float warp_sum[NWARP];
  __shared__ float row_scale;
  const long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  uint4* outr = reinterpret_cast<uint4*>(out + row * D);
  const int npack = D / PACK;

  float ss = 0.f;
  for (int i = threadIdx.x; i < npack; i += NT) {
    const uint4 raw = xr[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < PACK; ++j) {
      const float f = ptt::to_f32(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) t += warp_sum[i];
    row_scale = 1.0f / sqrtf(t / (float)D + eps);  // rsqrt(mean(x^2) + eps)
  }
  __syncthreads();
  const float r = row_scale;

  for (int i = threadIdx.x; i < npack; i += NT) {
    const uint4 raw = xr[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < PACK; ++j) {
      const int c = i * PACK + j;
      float y = ptt::to_f32(e[j]) * r * ptt::to_f32(w[c]);
      if (bias != nullptr) y += ptt::to_f32(bias[c]);
      o[j] = ptt::from_f32<T>(y);
    }
    outr[i] = packed;
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* b, void* out, int R, int D, float eps,
           cudaStream_t stream) {
  rms_norm_kernel<T, W><<<R, NT, 0, stream>>>(static_cast<const T*>(x), static_cast<const W*>(w),
                                              static_cast<const W*>(b), static_cast<T*>(out), D,
                                              eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_w(int w_dtype, const void* x, const void* w, const void* b, void* out, int R, int D,
               float eps, cudaStream_t s) {
  if (w_dtype == ptt::kF32) return launch<T, float>(x, w, b, out, R, D, eps, s);
  if (w_dtype == ptt::kBF16) return launch<T, __nv_bfloat16>(x, w, b, out, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes by paddle_tpu_torch/ops/kernels/build.py).
// x and out [R, D] contiguous of `x_dtype`, 16-byte aligned; w and the
// optional bias (null for none) [D] of `w_dtype`. Returns a cudaError_t
// code; 0 means the launch was accepted.
extern "C" int ptt_rms_norm(const void* x, const void* w, const void* bias, void* out,
                            int x_dtype, int w_dtype, int R, int D, float eps, void* stream) {
  if (R < 1 || D < 8 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ptt::kF32) return dispatch_w<float>(w_dtype, x, w, bias, out, R, D, eps, s);
  if (x_dtype == ptt::kBF16)
    return dispatch_w<__nv_bfloat16>(w_dtype, x, w, bias, out, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
