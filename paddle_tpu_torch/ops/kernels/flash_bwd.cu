// Flash attention backward for Hopper (sm_90a), paddle layout [B, S, H, D].
//
// Replaces: paddle_tpu/ops/pallas.py `_flash_bwd_impl` (:609) -- its two
// pallas_calls: dq (:649, kernel body `_bwd_dq_kernel` :482) and dk/dv
// (:687, kernel body `_bwd_dkdv_kernel` :530). The recompute-based FA2
// backward: the forward saved only out and the f32 logsumexp; both kernels
// rebuild p = exp(s - lse) tile by tile. delta = rowsum(dO * O) - g_lse is
// computed outside (ops/attention.py), as the JAX package does (:619-627).
//
//   dq kernel   one CTA of 256 threads per (b*h, 64-row q tile); loops over
//               32-key tiles up to the causal limit. Per tile it recomputes
//               s = q.k^T*scale, p = exp(s - lse), dp = dO.v^T (times the
//               dropout factor z = keep/(1-p) under dropout, hashed with the
//               q-head index b*H + h), ds = p*(dp - delta)*scale rounded to
//               the storage type, and accumulates dq += ds.K in registers.
//   dkdv kernel one CTA of 256 threads per (b*hkv, 64-key tile). The TPU
//               kernel made the GQA group a sequential grid axis that
//               revisits the output block; CUDA blocks run in no order, so
//               here the CTA itself loops over the group's q heads (hashing
//               dropout with that q head's index b*H + hkv*group + g, so the
//               mask is the forward's) and over 32-row q tiles from the
//               first one that sees its keys. dk and dv accumulate in f32
//               registers across the whole group -- no atomics, so a run is
//               deterministic -- and are cast once at the end (:667-670).
//               p*z is rounded to dO's type before dv += (p*z)^T.dO, and ds
//               to q's type before dk += ds^T.Q (:577, :582).
//
// Both take any Sq/Sk (out-of-range rows and keys contribute 0, as the
// forward kernel's), head_dim <= 256, f32 and bf16. Tiles are widened to
// f32 in shared memory, so products of bf16 inputs are exact and every
// sum is f32, as the MXU's bf16-in/f32-accumulate matmul.
//
// Bound on this card: at the training shape (S = 4096, D = 128, causal)
// dq does 6 and dk/dv 8 flops per visible (q, k) pair per head dimension
// against O(S*D) bytes, so both are bound by operations (tensor-core bf16
// peak). These first kernels run their products on the CUDA cores (f32
// FMA out of shared memory), an order of magnitude below that peak at
// best: they are correct and simple, and a wgmma/TMA rewrite with the
// score tile in registers is the work they leave on the table. Keeping
// the S x S score and probability tiles out of device memory is what the
// design does about bytes.

#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads: 16 x 16
constexpr int DQ_BQ = 64;   // dq: query rows per CTA (4 per thread row)
constexpr int DQ_BK = 32;   // dq: keys per inner tile (2 per thread column)
constexpr int KV_BK = 64;   // dkdv: keys per CTA
constexpr int KV_BQ = 32;   // dkdv: query rows per inner tile

template <int DMAX>
constexpr size_t dq_smem_floats() {
  return 2 * (size_t)DQ_BQ * (DMAX + 1) + 2 * (size_t)DQ_BK * (DMAX + 1) +
         (size_t)DQ_BQ * (DQ_BK + 1) + 2 * DQ_BQ;
}

template <int DMAX>
constexpr size_t dkdv_smem_floats() {
  return 2 * (size_t)KV_BK * (DMAX + 1) + 2 * (size_t)KV_BQ * (DMAX + 1) +
         2 * (size_t)KV_BQ * (KV_BK + 1) + 2 * KV_BQ;
}

// rows [r0, r0 + n) of one head of a [B, S, H, D] tensor (row stride
// `step`) into shared memory as f32 with row stride RS; zeros past `S`
// and past D
template <typename T, int DMAX>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int n, int S, long step,
                                          int D) {
  constexpr int RS = DMAX + 1;
  for (int i = threadIdx.x; i < n * DMAX; i += NT) {
    const int r = i / DMAX, c = i % DMAX;
    float x = 0.f;
    if (r0 + r < S && c < D) x = ptt::to_f32(src[(long)(r0 + r) * step + c]);
    dst[r * RS + c] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int D, int causal, float scale,
    int use_drop, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int RS = DMAX + 1;  // padded row stride: conflict-free column walks
  constexpr int PS = DQ_BK + 1;
  constexpr int CPT = DMAX / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + DQ_BQ * RS;
  float* Ks = dOs + DQ_BQ * RS;
  float* Vs = Ks + DQ_BK * RS;
  float* DSs = Vs + DQ_BK * RS;
  float* lse_s = DSs + DQ_BQ * PS;
  float* del_s = lse_s + DQ_BQ;

  const int bh = blockIdx.x;  // the q-head index of the dropout hash
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * DQ_BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int off = Sk - Sq;  // causal bottom-right alignment

  const long q_step = (long)H * D;
  const long kv_step = (long)Hkv * D;
  const long q_base = (long)b * Sq * q_step + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_step + (long)hk * D;
  const T* vb = v + (long)b * Sk * kv_step + (long)hk * D;

  load_rows<T, DMAX>(Qs, q + q_base, q0, DQ_BQ, Sq, q_step, D);
  load_rows<T, DMAX>(dOs, dout + q_base, q0, DQ_BQ, Sq, q_step, D);
  if (tid < DQ_BQ) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[(long)bh * Sq + q0 + tid] : 0.f;
    del_s[tid] = in ? delta[(long)bh * Sq + q0 + tid] : 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int n_k = (Sk + DQ_BK - 1) / DQ_BK;
  const int kmax = causal ? min(n_k, (off + q0 + DQ_BQ - 1) / DQ_BK + 1) : n_k;
  __syncthreads();

  for (int kt = 0; kt < kmax; ++kt) {
    const int k0 = kt * DQ_BK;
    load_rows<T, DMAX>(Ks, kb, k0, DQ_BK, Sk, kv_step, D);
    load_rows<T, DMAX>(Vs, vb, k0, DQ_BK, Sk, kv_step, D);
    __syncthreads();

    // s = q.k^T and dp = dO.v^T: rows ty*4+i, keys tx and tx+16
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[tx * RS + d], k1v = Ks[(tx + 16) * RS + d];
      const float v0v = Vs[tx * RS + d], v1v = Vs[(tx + 16) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty * 4 + i) * RS + d];
        const float ov = dOs[(ty * 4 + i) * RS + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
        dp[i][0] = fmaf(ov, v0v, dp[i][0]);
        dp[i][1] = fmaf(ov, v1v, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float ds = 0.f;  // hidden and out-of-range pairs: p = 0
        if (qpos < Sq && kpos < Sk && !(causal && kpos > qpos + off)) {
          const float p = expf(s[i][j] * scale - lse_s[r]);
          float dpv = dp[i][j];
          if (use_drop) {
            const bool keep = ptt::hash_keep(seed, (uint32_t)bh, (uint32_t)qpos, (uint32_t)kpos,
                                             thresh);
            dpv = keep ? dpv * inv_keep : 0.f;
          }
          ds = ptt::round_to<T>(p * (dpv - del_s[r]) * scale);  // ds in k's type (:520)
        }
        DSs[r * PS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    // dq += ds . K
    float dsv[4];
    for (int c = 0; c < DQ_BK; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = DSs[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float kv = Ks[c * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* dqb = dq + q_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dqb[(long)(q0 + r) * q_step + c] = ptt::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D, int causal,
    float scale, int use_drop, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int RS = DMAX + 1;
  constexpr int PS = KV_BK + 1;
  constexpr int CPT = DMAX / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + KV_BK * RS;
  float* Qs = Vs + KV_BK * RS;
  float* dOs = Qs + KV_BQ * RS;
  float* Ps = dOs + KV_BQ * RS;   // p*z in dO's type, [q row][key]
  float* DSs = Ps + KV_BQ * PS;   // ds in q's type, [q row][key]
  float* lse_s = DSs + KV_BQ * PS;
  float* del_s = lse_s + KV_BQ;

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * KV_BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int off = Sk - Sq;

  const long q_step = (long)H * D;
  const long kv_step = (long)Hkv * D;
  const long kv_base = (long)b * Sk * kv_step + (long)hk * D;
  load_rows<T, DMAX>(Ks, k + kv_base, k0, KV_BK, Sk, kv_step, D);
  load_rows<T, DMAX>(Vs, v + kv_base, k0, KV_BK, Sk, kv_step, D);

  float adk[4][CPT], adv[4][CPT];  // keys ty*4+i, columns tx+16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  // first q tile whose last row sees this key tile (:552)
  const int qt0 = causal ? max(k0 - off, 0) / KV_BQ : 0;
  const int n_qt = (Sq + KV_BQ - 1) / KV_BQ;

  for (int g = 0; g < group; ++g) {
    const int bhq = b * H + hk * group + g;  // the q head's hash identity (:545)
    const long q_base = (long)b * Sq * q_step + (long)(hk * group + g) * D;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int qs0 = qt * KV_BQ;
      __syncthreads();  // the previous tile's readers are done with Qs/dOs/Ps/DSs
      load_rows<T, DMAX>(Qs, q + q_base, qs0, KV_BQ, Sq, q_step, D);
      load_rows<T, DMAX>(dOs, dout + q_base, qs0, KV_BQ, Sq, q_step, D);
      if (tid < KV_BQ) {
        const bool in = qs0 + tid < Sq;
        lse_s[tid] = in ? lse[(long)bhq * Sq + qs0 + tid] : 0.f;
        del_s[tid] = in ? delta[(long)bhq * Sq + qs0 + tid] : 0.f;
      }
      __syncthreads();

      // s and dp for keys ty*4+i, q rows tx and tx+16
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float q0v = Qs[tx * RS + d], q1v = Qs[(tx + 16) * RS + d];
        const float o0v = dOs[tx * RS + d], o1v = dOs[(tx + 16) * RS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kv = Ks[(ty * 4 + i) * RS + d];
          const float vv = Vs[(ty * 4 + i) * RS + d];
          s[i][0] = fmaf(q0v, kv, s[i][0]);
          s[i][1] = fmaf(q1v, kv, s[i][1]);
          dp[i][0] = fmaf(o0v, vv, dp[i][0]);
          dp[i][1] = fmaf(o1v, vv, dp[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = ty * 4 + i;
        const int kpos = k0 + key;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = tx + 16 * j;
          const int qpos = qs0 + r;
          float pz = 0.f, ds = 0.f;
          if (qpos < Sq && kpos < Sk && !(causal && kpos > qpos + off)) {
            const float p = expf(s[i][j] * scale - lse_s[r]);
            float dpv = dp[i][j];
            pz = p;
            if (use_drop) {
              const bool keep = ptt::hash_keep(seed, (uint32_t)bhq, (uint32_t)qpos,
                                               (uint32_t)kpos, thresh);
              const float z = keep ? inv_keep : 0.f;
              pz = p * z;
              dpv = dpv * z;
            }
            pz = ptt::round_to<T>(pz);
            ds = ptt::round_to<T>(p * (dpv - del_s[r]) * scale);
          }
          Ps[r * PS + key] = pz;
          DSs[r * PS + key] = ds;
        }
      }
      __syncthreads();

      // dv += (p*z)^T . dO and dk += ds^T . Q over this tile's rows
      float pv[4], dsv[4];
      for (int c = 0; c < KV_BQ; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[c * PS + ty * 4 + i];
          dsv[i] = DSs[c * PS + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float ov = dOs[c * RS + tx + 16 * j];
          const float qv = Qs[c * RS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] = fmaf(pv[i], ov, adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv, adk[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + kv_base;
  T* dvb = dv + kv_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dkb[(long)kpos * kv_step + c] = ptt::from_f32<T>(adk[i][j]);
        dvb[(long)kpos * kv_step + c] = ptt::from_f32<T>(adv[i][j]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o0, *o1;  // dq; or dk, dv
  int B, Sq, Sk, H, Hkv, D, causal;
  float scale;
  int use_drop;
  uint32_t seed, thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int DMAX>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<DMAX>() * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.Sq + DQ_BQ - 1) / DQ_BQ);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.o0), a.Sq, a.Sk, a.H,
      a.Hkv, a.D, a.causal, a.scale, a.use_drop, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkdv(const Args& a) {
  const size_t smem = dkdv_smem_floats<DMAX>() * sizeof(float);
  auto kern = flash_bwd_dkdv_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.Hkv, (a.Sk + KV_BK - 1) / KV_BK);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.o0),
      static_cast<T*>(a.o1), a.Sq, a.Sk, a.H, a.Hkv, a.D, a.causal, a.scale, a.use_drop, a.seed,
      a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, bool DKDV>
int dispatch_d(const Args& a) {
  if (a.D <= 64) return DKDV ? launch_dkdv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.D <= 128) return DKDV ? launch_dkdv<T, 128>(a) : launch_dq<T, 128>(a);
  return DKDV ? launch_dkdv<T, 256>(a) : launch_dq<T, 256>(a);
}

template <bool DKDV>
int dispatch(int dtype, const Args& a) {
  if (a.D < 1 || a.D > 256 || a.Hkv < 1 || a.H % a.Hkv != 0 || a.Sq < 1 || a.Sk < 1 ||
      (a.causal && a.Sk < a.Sq))
    return (int)cudaErrorInvalidValue;
  if (dtype == ptt::kF32) return dispatch_d<float, DKDV>(a);
  if (dtype == ptt::kBF16) return dispatch_d<__nv_bfloat16, DKDV>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes by paddle_tpu_torch/ops/kernels/build.py).
// Returns a cudaError_t code; 0 means the launch was accepted. lse and
// delta are f32 [B, H, Sq]; every other tensor is contiguous [B, S, H(kv), D]
// of `dtype`.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int dtype, int B,
                                int Sq, int Sk, int H, int Hkv, int D, int causal, float scale,
                                int use_drop, unsigned int seed, unsigned int thresh,
                                float inv_keep, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dq,
         nullptr, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed, thresh, inv_keep,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, a);
}

extern "C" int ptt_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int dtype, int B, int Sq, int Sk, int H, int Hkv, int D,
                                  int causal, float scale, int use_drop, unsigned int seed,
                                  unsigned int thresh, float inv_keep, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dk,
         dv, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed, thresh, inv_keep,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, a);
}
