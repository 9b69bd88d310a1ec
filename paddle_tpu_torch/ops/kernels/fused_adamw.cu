// One-pass AdamW/Adam update over one flat optimizer bucket, for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/fused_optimizer.py `_pallas_apply` (pallas_call
// at :154, kernel body `_kernel` :113; entry `fused_adamw_apply` :186).
// Per element, in f32 and in exactly the order of `_update_math` (:98-110):
//   g  = g * clip;                      Adam: g = g + wd * p
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   u  = (m' / c1) / (sqrt(v' / c2) + eps);   AdamW: u = u + wd * p
//   p' = p - lr * u
// (this is not torch.optim's form). Every operation is a correctly rounded
// single-precision intrinsic (__fmul_rn, __fadd_rn, ...), so nvcc cannot
// contract a multiply and an add into an FMA: the kernel rounds where the
// plain PyTorch version rounds. With a bf16 second moment, v' is rounded
// stochastically: the murmur-style hash of the element's flat position as
// uint32 (the JAX kernel's iota(uint32)) and the per-step seed adds noise
// below the bf16 cut, then the low 16 bits are dropped (`_sr_bits_flat`,
// :83-95). Zero padding lanes stay zero (g = 0 gives m' = v' = u = 0).
//
// Design. The TPU kernel streams (rows, 1024) tiles through VMEM along a
// sequential grid. Here a grid-stride loop with 64-bit element offsets
// walks the bucket (a 4-layer Llama-3-8B bucket holds 1.135e9 elements; 8
// layers would pass 2^31). lr, clip, c1 and c2 are read from a 4-float
// device array, so a clip scale computed on the card needs no host sync.
// p, m and v are updated in place in the caller's buffers.
//
// Bound on this card: bytes. Each element reads p, m, v, g once and writes
// p, m, v once: 28 bytes with an f32 second moment, 24 with bf16, against
// ~20 flops, far below the ~300 flops per byte where the card turns
// compute-bound. This first kernel makes one 4-byte (or 2-byte) access per
// stream per element, coalesced across the warp; 16-byte vector accesses
// and more bytes in flight per thread are what it leaves on the table.

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename P, typename V, typename G>
__global__ void __launch_bounds__(NT) fused_adamw_kernel(
    P* __restrict__ p, float* __restrict__ m, V* __restrict__ v, const G* __restrict__ g,
    const float* __restrict__ scal, long long n, uint32_t seed, float beta1, float one_m_beta1,
    float beta2, float one_m_beta2, float eps, float wd, int decoupled) {
  const float lr = scal[0], clip = scal[1], c1 = scal[2], c2 = scal[3];
  const bool coupled_wd = wd != 0.f && !decoupled;
  const bool decoupled_wd = wd != 0.f && decoupled;
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n; i += stride) {
    const float pf = ptt::to_f32(p[i]);
    float gf = __fmul_rn(ptt::to_f32(g[i]), clip);
    if (coupled_wd) gf = __fadd_rn(gf, __fmul_rn(wd, pf));
    const float mn = __fadd_rn(__fmul_rn(beta1, m[i]), __fmul_rn(one_m_beta1, gf));
    const float vn = __fadd_rn(__fmul_rn(beta2, ptt::to_f32(v[i])),
                               __fmul_rn(__fmul_rn(one_m_beta2, gf), gf));
    float upd = __fdiv_rn(__fdiv_rn(mn, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, c2)), eps));
    if (decoupled_wd) upd = __fadd_rn(upd, __fmul_rn(wd, pf));
    p[i] = ptt::from_f32<P>(__fsub_rn(pf, __fmul_rn(lr, upd)));
    m[i] = mn;
    if constexpr (sizeof(V) == 4) {
      v[i] = vn;
    } else {
      // stochastic rounding keyed by the flat index as uint32
      uint32_t u = ((uint32_t)i * 0x9E3779B1u) ^ seed;
      u ^= u >> 16;
      u *= 0x85EBCA6Bu;
      u ^= u >> 13;
      const uint32_t kept = (__float_as_uint(vn) + (u & 0xFFFFu)) & 0xFFFF0000u;
      v[i] = __ushort_as_bfloat16((unsigned short)(kept >> 16));
    }
  }
}

template <typename P, typename V, typename G>
int launch(void* p, void* m, void* v, const void* g, const float* scal, long long n, uint32_t seed,
           float b1, float omb1, float b2, float omb2, float eps, float wd, int decoupled,
           cudaStream_t stream) {
  long long blocks = (n + NT - 1) / NT;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  fused_adamw_kernel<P, V, G><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<P*>(p), static_cast<float*>(m), static_cast<V*>(v), static_cast<const G*>(g),
      scal, n, seed, b1, omb1, b2, omb2, eps, wd, decoupled);
  return (int)cudaGetLastError();
}

template <typename P, typename V>
int dispatch_g(int g_dtype, void* p, void* m, void* v, const void* g, const float* scal,
               long long n, uint32_t seed, float b1, float omb1, float b2, float omb2, float eps,
               float wd, int decoupled, cudaStream_t s) {
  if (g_dtype == ptt::kF32)
    return launch<P, V, float>(p, m, v, g, scal, n, seed, b1, omb1, b2, omb2, eps, wd, decoupled, s);
  if (g_dtype == ptt::kBF16)
    return launch<P, V, __nv_bfloat16>(p, m, v, g, scal, n, seed, b1, omb1, b2, omb2, eps, wd,
                                       decoupled, s);
  return (int)cudaErrorInvalidValue;
}

template <typename P>
int dispatch_v(int v_dtype, int g_dtype, void* p, void* m, void* v, const void* g,
               const float* scal, long long n, uint32_t seed, float b1, float omb1, float b2,
               float omb2, float eps, float wd, int decoupled, cudaStream_t s) {
  if (v_dtype == ptt::kF32)
    return dispatch_g<P, float>(g_dtype, p, m, v, g, scal, n, seed, b1, omb1, b2, omb2, eps, wd,
                                decoupled, s);
  if (v_dtype == ptt::kBF16)
    return dispatch_g<P, __nv_bfloat16>(g_dtype, p, m, v, g, scal, n, seed, b1, omb1, b2, omb2,
                                        eps, wd, decoupled, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes by paddle_tpu_torch/ops/kernels/build.py).
// p [n] f32/bf16, m [n] f32, v [n] f32/bf16, g [n] f32/bf16, scal f32[4] =
// (lr, clip, c1, c2) on the device; p, m and v are updated in place.
// Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int ptt_fused_adamw(void* p, void* m, void* v, const void* g, const void* scal,
                               long long n, int p_dtype, int v_dtype, int g_dtype,
                               unsigned int seed, float beta1, float one_m_beta1, float beta2,
                               float one_m_beta2, float eps, float wd, int decoupled,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scal);
  if (p_dtype == ptt::kF32)
    return dispatch_v<float>(v_dtype, g_dtype, p, m, v, g, sc, n, seed, beta1, one_m_beta1, beta2,
                             one_m_beta2, eps, wd, decoupled, s);
  if (p_dtype == ptt::kBF16)
    return dispatch_v<__nv_bfloat16>(v_dtype, g_dtype, p, m, v, g, sc, n, seed, beta1,
                                     one_m_beta1, beta2, one_m_beta2, eps, wd, decoupled, s);
  return (int)cudaErrorInvalidValue;
}
