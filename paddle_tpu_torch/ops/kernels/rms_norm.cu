// RMSNorm forward over rows for Hopper (sm_90a).
//
// Replaces: paddle_tpu/incubate/nn/functional/__init__.py
// `_rms_norm_pallas_fwd_impl` (pallas_call at :88; entry `fused_rms_norm`
// :101): out = x * rsqrt(mean(x^2) + eps) * w (+ b), computed in f32 and
// cast to x's type. The backward recomputes through the plain version, as
// the JAX package's custom_vjp does (:57-63), so there is no backward
// kernel.
//
// Bound on this card: bytes (read x once, write out once, ~4 flops per
// element). At the Llama-3-8B width (R = 4096 tokens, D = 4096, bf16) that
// is 67 MB, 0.02 ms at 3.35 TB/s.
//
// Design. The TPU kernel takes 256-row blocks through VMEM. Here one CTA
// of 128 threads takes one row (four 16-byte packs a thread at D4096
// bf16; 64, 256 and 512 threads measured slower, PERF.md): each thread
// sums the squares of its 16-byte packs of the row in f32, a
// warp-shuffle and shared-memory reduction gives the row's sum, and a second pass over the row (mostly
// served from L1/L2) writes the output in 16-byte packs, reading the
// weight (and bias) as packs too. Any number of rows and any D that is a
// multiple of 8 (a row is a whole number of 16-byte packs in f32 and in
// bf16); x, w and b 16-byte aligned. The wrapper checks both.
//
// Holding the row in registers (x read once, several rows a CTA) gains
// little here, since the second pass hits L1/L2 and the kernel moves its
// bytes near a plain copy's rate, and it would need a template instance
// per row width (PERF.md, B6).

#include "common.cuh"

namespace {

// `N` values of W as one aligned unit: one 16-byte load (two for a pack
// of 8 f32, one 8-byte load for 4 bf16)
template <typename W, int N>
struct alignas(N * sizeof(W) < 16 ? N * sizeof(W) : 16) Vec {
  W v[N];
};

// threads a CTA; cuda_kernel_variants.py builds other values to compare them
#ifndef PTT_RMS_THREADS
#define PTT_RMS_THREADS 128
#endif
constexpr int NT = PTT_RMS_THREADS;
constexpr int NWARP = NT / 32;

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rms_norm_kernel(const T* __restrict__ x,
                                                      const W* __restrict__ w,
                                                      const W* __restrict__ bias,
                                                      T* __restrict__ out, int D, float eps) {
  constexpr int PACK = 16 / sizeof(T);
  using XV = Vec<T, PACK>;
  using WV = Vec<W, PACK>;
  __shared__ float warp_sum[NWARP];
  const XV* xr = reinterpret_cast<const XV*>(x + (long)blockIdx.x * D);
  XV* outr = reinterpret_cast<XV*>(out + (long)blockIdx.x * D);
  const int npack = D / PACK;

  float ss = 0.f;
  for (int i = threadIdx.x; i < npack; i += NT) {
    const XV e = xr[i];
#pragma unroll
    for (int j = 0; j < PACK; ++j) {
      const float f = ptt::to_f32(e.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = ss;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NWARP; ++i) t += warp_sum[i];
  const float r = 1.0f / sqrtf(t / (float)D + eps);  // rsqrt(mean(x^2) + eps)

  for (int i = threadIdx.x; i < npack; i += NT) {
    const XV e = xr[i];
    const WV wv = reinterpret_cast<const WV*>(w)[i];
    WV bv;
    if (bias != nullptr) bv = reinterpret_cast<const WV*>(bias)[i];
    XV o;
#pragma unroll
    for (int j = 0; j < PACK; ++j) {
      float y = ptt::to_f32(e.v[j]) * r * ptt::to_f32(wv.v[j]);
      if (bias != nullptr) y += ptt::to_f32(bv.v[j]);
      o.v[j] = ptt::from_f32<T>(y);
    }
    outr[i] = o;
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
// x and out [R, D] contiguous of `x_dtype`; w and the optional bias (null
// for none) [D] of `w_dtype`; all 16-byte aligned. Returns a cudaError_t
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
