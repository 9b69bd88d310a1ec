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
// Both CUDA-core kernels take any Sq/Sk (out-of-range rows and keys
// contribute 0, as the forward kernel's), head_dim <= 256, f32, bf16 and
// f16. Tiles are widened to f32 in shared memory, so products of 16-bit inputs
// are exact and every sum is f32, as the MXU's bf16-in/f32-accumulate
// matmul.
//
// Both have a second, tensor-core variant for bf16 and f16 at head_dim 64
// or 128 (namespace tc below; the design notes are there; the element
// type is a template parameter, and f16 takes the f16 form of every wgmma
// and tensor map). dk/dv: K and V
// resident in shared memory, Q/dO tiles streamed by TMA through a ring,
// all four products on wgmma with f32 accumulators in registers, P^T and
// dS^T built on the fragments and fed back as register A operands. dq:
// Q and dO resident, K/V tiles streamed, S and dP on wgmma, dS built on
// the fragments and fed back as the A operand of dQ += dS.K.
// ops/attention.py `kernel_variant` picks the variant on dtype and
// head_dim alone; f32 stays on CUDA cores (tensor cores would take it as
// TF32).
//
// Bound on this card: at the training shape (S = 4096, D = 128, causal)
// dq does 6 and dk/dv 8 flops per visible (q, k) pair per head dimension
// against O(S*D) bytes, so both are bound by operations: 989 TFLOP/s of
// bf16 tensor-core peak (dq 0.209 ms, dk/dv 0.278 ms there). The CUDA-core
// kernels run f32 FMA out of shared memory, ~40-50x above that bound (dq
// 8.6 ms, dk/dv 14.44 ms); the tensor-core kernels put their products on
// wgmma and keep the score and probability tiles in registers, which is
// what their design does about operations and bytes.

#include "common.cuh"
#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// dk/dv, bf16/f16 tensor-core variant (head_dim 64 or 128)
// ---------------------------------------------------------------------------
//
// One CTA of 384 threads per (b*hkv, 128-key tile); key tile 0, which
// every causal q tile sees, is launched first. Warpgroup 2 is the
// producer. It keeps 24 registers a thread and hands the rest to the two
// consumer warpgroups (240 each): dK and dV alone take 128 f32 registers
// a thread at D = 128, and ptxas holds a 384-thread CTA to 168. Its first
// warp does the work: lane 0 loads the CTA's K and V tiles once (they
// stay in shared memory) and streams each (q head g of the group, 32-row
// q tile) through a 2-stage ring: Q and dO by TMA, lse (times log2 e) and
// delta by the warp's 32 lanes (a TMA row of lse is 16-byte aligned only
// when Sq % 4 == 0). A stage's "full" mbarrier takes the 32 lanes'
// arrivals and the TMA bytes, its "empty" one the 256 consumer threads'.
// Warps 0-7 are two consumer warpgroups, each owning 64 of the keys. Per
// stage a warpgroup runs S^T = K.Q^T and dP^T = V.dO^T (wgmma m64n32k16,
// both operands K-major in shared memory) and builds P^T = exp(S^T - lse)
// on the accumulator fragments (the dropout hash keyed by that q head,
// b*H + hkv*group + g, at each element's own (q row, key)). P^T z, rounded
// to the storage type in registers, is at once the A operand of dV += (P^T z).dO
// (register-A wgmma m64nDk16, dO read MN-major); while that runs,
// dS^T = P^T (dP^T z - delta) scale is built and rounded the same way
// and feeds dK += dS^T.Q, which reads the same Q tile MN-major. dK and dV
// stay in f32 registers across the whole group and every q tile: the GQA
// sum is in f32 inside the CTA, with no atomics, and a run is
// deterministic. A warpgroup skips the products of a q tile whose rows
// see none of its keys; causal and ragged masking runs only on tiles that
// cross the diagonal or a sequence end. Measured on the H100 at S4096
// (tiles of 64, then 32 q rows; dV issued before dS is built; the warp
// index made provably uniform; dropout compiled out when off): 1.83,
// 1.29, 1.12 and 0.89 ms.

namespace tc {

constexpr int BKV = 128;  // keys per CTA: two warpgroups of 64
constexpr int BQ = 32;    // q rows per stage
constexpr int STAGES = 2;
constexpr int NT = 384;   // 2 consumer warpgroups + 1 producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
// registers a thread after the hand-over: 128 x 24 + 256 x 240 = 384 x 168,
// the CTA's registers at launch (65536 / 384, rounded down to 8)
constexpr uint32_t PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int D>
struct Layout {
  static constexpr int KV_HALF = BKV * 128;  // bytes of one 64-column half of K or V
  static constexpr int Q_HALF = BQ * 128;    // ... of a Q or dO stage
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int LSE_OFF = DO_OFF + STAGES * Q_BYTES;  // [STAGES][BQ] f32
  static constexpr int DEL_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DEL_OFF + STAGES * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// DROP: dropout is a template parameter here, not a runtime flag: with
// the hash in the loop ptxas keeps the consumers under 168 registers and
// spills (0.89 ms without it against 1.12 ms with it, S4096 on the H100)
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int causal, float scale,
    uint32_t seed, uint32_t thresh, float inv_keep) {
  using L = Layout<D>;
  namespace s9 = ptt::sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = s9::align_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* del_s = reinterpret_cast<float*>(smem + L::DEL_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * BKV;
  const int off = Sk - Sq;
  // the first q tile whose last row sees this key tile (pallas.py:552)
  const int qt0 = causal ? max(k0 - off, 0) / BQ : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int per_head = n_qt - qt0;
  const int n_tiles = group * per_head;
  // the warp index through a shuffle from lane 0: the compiler then knows
  // it is uniform across the warp (the role branch below relies on it)
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    s9::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      s9::mbar_init(&full[s], 32);
      s9::mbar_init(&empty[s], 256);
    }
    s9::mbar_fence_init();
  }
  __syncthreads();

  // one if/else for the two roles, never rejoined: ptxas honours
  // setmaxnreg only then
  if (warp >= 8) {  // the producer warpgroup; its first warp works
    s9::reg_dealloc<PRODUCER_REGS>();
    if (warp == 8) {
      if (lane == 0) {
        s9::mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          s9::tma_load_4d(smem + c * L::KV_HALF, &tm_k, kv_full, 64 * c, hk, k0, b);
          s9::tma_load_4d(smem + L::V_OFF + c * L::KV_HALF, &tm_v, kv_full, 64 * c, hk, k0, b);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int hq = hk * group + t / per_head;
        const int qs0 = (qt0 + t % per_head) * BQ;
        const long row = (long)(b * H + hq) * Sq;
        s9::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        for (int r = lane; r < BQ; r += 32) {
          const bool in = qs0 + r < Sq;  // rows past Sq: p = 0, ds = 0
          lse_s[s * BQ + r] = in ? lse[row + qs0 + r] * LOG2E : INFINITY;
          del_s[s * BQ + r] = in ? delta[row + qs0 + r] : 0.f;
        }
        if (lane == 0) {
          s9::mbar_arrive_expect_tx(&full[s], 2 * L::Q_BYTES);
          uint8_t* qd = smem + L::Q_OFF + s * L::Q_BYTES;
          uint8_t* dd = smem + L::DO_OFF + s * L::Q_BYTES;
          for (int c = 0; c < D / 64; ++c) {
            s9::tma_load_4d(qd + c * L::Q_HALF, &tm_q, &full[s], 64 * c, hq, qs0, b);
            s9::tma_load_4d(dd + c * L::Q_HALF, &tm_do, &full[s], 64 * c, hq, qs0, b);
          }
        } else {
          s9::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64); this
    // thread keys r and r + 8 of them, q rows 8 j + cq + {0, 1} of a tile
    s9::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4;
    const int kw0 = k0 + 64 * wg;
    const int key0 = kw0 + (warp % 4) * 16 + lane / 4;
    const int cq = (lane % 4) * 2;
    const float scale_log2 = scale * LOG2E;
    const uint32_t k_addr = s9::smem_u32(smem) + wg * 64 * 128;
    const uint32_t v_addr = s9::smem_u32(smem + L::V_OFF) + wg * 64 * 128;

    float adk[D / 2], adv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) adk[j] = adv[j] = 0.f;

    s9::mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int bhq = b * H + hk * group + t / per_head;  // the q head's hash identity (:545)
      const int qs0 = (qt0 + t % per_head) * BQ;
      s9::mbar_wait(&full[s], (t / STAGES) & 1);
      if (causal && kw0 > qs0 + BQ - 1 + off) {  // no row of this tile sees these keys
        s9::mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t q_addr = s9::smem_u32(smem + L::Q_OFF + s * L::Q_BYTES);
      const uint32_t do_addr = s9::smem_u32(smem + L::DO_OFF + s * L::Q_BYTES);

      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = dpt[j] = 0.f;
      s9::fence_regs(st);
      s9::fence_regs(dpt);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = kk / 4, sub = (kk % 4) * 32u;
        s9::wgmma_ss<BQ, T>(st, s9::desc_k(k_addr + at * L::KV_HALF + sub),
                         s9::desc_k(q_addr + at * L::Q_HALF + sub), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = kk / 4, sub = (kk % 4) * 32u;
        s9::wgmma_ss<BQ, T>(dpt, s9::desc_k(v_addr + at * L::KV_HALF + sub),
                         s9::desc_k(do_addr + at * L::Q_HALF + sub), kk > 0);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(st);
      s9::fence_regs(dpt);

      const float* ls = lse_s + s * BQ;
      const float* ds_ = del_s + s * BQ;
      const bool mask = qs0 + BQ > Sq || kw0 + 64 > Sk || (causal && kw0 + 63 > qs0 + off);
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < BQ / 2; j += 2) {
        float pz2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * (j / 4) + cq + e;
          const int qpos = qs0 + col;
          const int kpos = key0 + 8 * ((j >> 1) & 1);
          float p = exp2f(st[j + e] * scale_log2 - ls[col]);
          if (mask && (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos + off))) p = 0.f;
          float dp = dpt[j + e], pz = p;
          if constexpr (DROP) {
            const bool keep = ptt::hash_keep(seed, (uint32_t)bhq, (uint32_t)qpos, (uint32_t)kpos,
                                             thresh);
            const float z = keep ? inv_keep : 0.f;
            pz = p * z;
            dp = dp * z;
          }
          st[j + e] = p;
          dpt[j + e] = dp;
          pz2[e] = pz;
        }
        pa[j / 8][(j % 8) / 2] = s9::pack2<T>(pz2[0], pz2[1]);
      }
      s9::fence_regs(adv);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t bd = s9::desc_mn(do_addr + kk * 2048u, L::Q_HALF);
        s9::wgmma_rs<D, T>(adv, pa[kk], bd, 1);
      }
      s9::wgmma_commit();
#pragma unroll
      for (int j = 0; j < BQ / 2; j += 2) {
        const int col = 8 * (j / 4) + cq;
        sa[j / 8][(j % 8) / 2] = s9::pack2<T>(st[j] * (dpt[j] - ds_[col]) * scale,
                                               st[j + 1] * (dpt[j + 1] - ds_[col + 1]) * scale);
      }
      s9::fence_regs(adk);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t bq = s9::desc_mn(q_addr + kk * 2048u, L::Q_HALF);
        s9::wgmma_rs<D, T>(adk, sa[kk], bq, 1);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(adv);
      s9::fence_regs(adk);
      s9::mbar_arrive(&empty[s]);
    }

    const long kv_step = (long)Hkv * D;
    const long base = (long)b * Sk * kv_step + (long)hk * D + cq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = key0 + 8 * r;
      if (kpos >= Sk) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const long o = base + (long)kpos * kv_step + 8 * c;
        const int i = 4 * c + 2 * r;
        *reinterpret_cast<uint32_t*>(dk + o) = s9::pack2<T>(adk[i], adk[i + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) = s9::pack2<T>(adv[i], adv[i + 1]);
      }
    }
  }
}

template <typename T, int D>
int launch_dkdv(const Args& a) {
  namespace s9 = ptt::sm90;
  CUtensorMap mq, mk, mv, mdo;
  int rc = s9::encode_bshd<T>(&mq, a.q, a.B, a.Sq, a.H, D, BQ);
  if (rc == 0) rc = s9::encode_bshd<T>(&mdo, a.dout, a.B, a.Sq, a.H, D, BQ);
  if (rc == 0) rc = s9::encode_bshd<T>(&mk, a.k, a.B, a.Sk, a.Hkv, D, BKV);
  if (rc == 0) rc = s9::encode_bshd<T>(&mv, a.v, a.B, a.Sk, a.Hkv, D, BKV);
  if (rc != 0) return rc;
  auto kern = a.use_drop ? flash_bwd_dkdv_tc_kernel<T, D, true>
                         : flash_bwd_dkdv_tc_kernel<T, D, false>;
  const int smem = Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.Hkv, (a.Sk + BKV - 1) / BKV);
  kern<<<grid, NT, smem, a.stream>>>(mq, mk, mv, mdo, a.lse, a.delta,
                                     static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.Sq, a.Sk, a.H, a.Hkv,
                                     a.causal, a.scale, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dq, bf16/f16 tensor-core variant (head_dim 64 or 128)
// ---------------------------------------------------------------------------
//
// One CTA of 384 threads per (b*h, 128-row q tile), the heaviest causal
// tiles launched first (blockIdx.y counts q tiles from the last, as the
// forward). Warpgroup 2 is the producer, with 24 registers a thread; its
// first lane loads the CTA's Q and dO tiles once by TMA (they stay in
// shared memory) and streams the K and V tiles of kv head h / group
// through a 3-stage ring ("full": the TMA bytes; "empty": the 256
// consumer arrivals), zero-filled past Sk. Warps 0-7 are two consumer
// warpgroups, each owning 64 q rows, with 240 registers a thread. Per key
// tile a warpgroup runs S = Q.K^T and dP = dO.V^T (wgmma m64nKk16, both
// operands K-major in shared memory), builds p = exp2(S scale log2 e -
// lse log2 e) on the accumulator fragments, dP z under dropout (the hash
// keyed by the q head b*H + h, the forward's key, at each element's own
// (q row, key)), and dS = p (dP z - delta) scale rounded to the storage type in
// registers, where it is already the A fragment of dQ += dS.K (register-A
// wgmma m64nDk16), which reads the same K tile MN-major. dQ stays in f32
// registers across every key tile and is written once: the CTA owns its
// rows, with no atomics, and a run is deterministic. lse and delta are
// constant per row: each thread loads its two rows' values into registers
// once (no TMA row of lse, so no alignment condition on Sq). Masking runs
// only on tiles that cross the causal diagonal or Sk; rows past Sq take
// lse = +inf, so p = 0 there.

// Keys per stage and the ring's depth: cuda_kernel_variants.py builds
// other values (-DPTT_DQ_KEYS=128 -DPTT_DQ_STAGES=2) to compare them.
#ifndef PTT_DQ_KEYS
#define PTT_DQ_KEYS 64
#endif
#ifndef PTT_DQ_STAGES
#define PTT_DQ_STAGES 3
#endif
constexpr int DQ_ROWS = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int DQ_KEYS = PTT_DQ_KEYS;
constexpr int DQ_STAGES = PTT_DQ_STAGES;

template <int D>
struct DqLayout {
  static constexpr int Q_HALF = DQ_ROWS * 128;   // bytes of one 64-column half of Q or dO
  static constexpr int KV_HALF = DQ_KEYS * 128;  // ... of a K or V stage
  static constexpr int Q_BYTES = DQ_ROWS * D * 2;
  static constexpr int KV_BYTES = DQ_KEYS * D * 2;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + DQ_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + DQ_STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * DQ_STAGES) + 1024;  // + alignment slack
};

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int Sq, int Sk, int H, int Hkv, int causal, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep) {
  using L = DqLayout<D>;
  namespace s9 = ptt::sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = s9::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int bh = blockIdx.x;  // the q head: the dropout hash's identity (pallas.py:490)
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;  // heaviest causal tile first
  const int off = Sk - Sq;                                // causal bottom-right alignment
  const int n_k = (Sk + DQ_KEYS - 1) / DQ_KEYS;
  const int last_row = min(q0 + DQ_ROWS, Sq) - 1;
  const int kmax = causal ? min(n_k, (last_row + off) / DQ_KEYS + 1) : n_k;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    s9::mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      s9::mbar_init(&full[s], 1);
      s9::mbar_init(&empty[s], 256);
    }
    s9::mbar_fence_init();
  }
  __syncthreads();

  // one if/else for the two roles, never rejoined (setmaxnreg)
  if (warp >= 8) {
    s9::reg_dealloc<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      s9::mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        s9::tma_load_4d(smem + c * L::Q_HALF, &tm_q, q_full, 64 * c, h, q0, b);
        s9::tma_load_4d(smem + L::DO_OFF + c * L::Q_HALF, &tm_do, q_full, 64 * c, h, q0, b);
      }
      for (int i = 0; i < kmax; ++i) {
        const int s = i % DQ_STAGES;
        s9::mbar_wait(&empty[s], ((i / DQ_STAGES) & 1) ^ 1);
        s9::mbar_arrive_expect_tx(&full[s], 2 * L::KV_BYTES);
        uint8_t* kd = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* vd = smem + L::V_OFF + s * L::KV_BYTES;
        for (int c = 0; c < D / 64; ++c) {
          s9::tma_load_4d(kd + c * L::KV_HALF, &tm_k, &full[s], 64 * c, hk, i * DQ_KEYS, b);
          s9::tma_load_4d(vd + c * L::KV_HALF, &tm_v, &full[s], 64 * c, hk, i * DQ_KEYS, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows [qw0, qw0 + 64); this thread rows
    // r and r + 8 of them, keys 8 j + cq + {0, 1} of a tile
    s9::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4;
    const int qw0 = q0 + 64 * wg;
    const int row0 = qw0 + (warp % 4) * 16 + lane / 4;
    const int cq = (lane % 4) * 2;
    const float scale_log2 = scale * LOG2E;
    const uint32_t q_addr = s9::smem_u32(smem) + wg * 64 * 128;
    const uint32_t do_addr = s9::smem_u32(smem + L::DO_OFF) + wg * 64 * 128;
    float lse2[2], dl[2];  // this thread's rows: lse log2 e and delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      const bool in = qpos < Sq;
      lse2[r] = in ? lse[(long)bh * Sq + qpos] * LOG2E : INFINITY;
      dl[r] = in ? delta[(long)bh * Sq + qpos] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

    s9::mbar_wait(q_full, 0);
    for (int i = 0; i < kmax; ++i) {
      const int s = i % DQ_STAGES;
      const int k0 = i * DQ_KEYS;
      s9::mbar_wait(&full[s], (i / DQ_STAGES) & 1);
      if (qw0 >= Sq || (causal && k0 > qw0 + 63 + off)) {  // no row here sees these keys
        s9::mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t k_addr = s9::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
      const uint32_t v_addr = s9::smem_u32(smem + L::V_OFF + s * L::KV_BYTES);

      float sc[DQ_KEYS / 2], dp[DQ_KEYS / 2];
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 2; ++j) sc[j] = dp[j] = 0.f;
      s9::fence_regs(sc);
      s9::fence_regs(dp);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = kk / 4, sub = (kk % 4) * 32u;
        s9::wgmma_ss<DQ_KEYS, T>(sc, s9::desc_k(q_addr + at * L::Q_HALF + sub),
                              s9::desc_k(k_addr + at * L::KV_HALF + sub), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = kk / 4, sub = (kk % 4) * 32u;
        s9::wgmma_ss<DQ_KEYS, T>(dp, s9::desc_k(do_addr + at * L::Q_HALF + sub),
                              s9::desc_k(v_addr + at * L::KV_HALF + sub), kk > 0);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(sc);
      s9::fence_regs(dp);

      const bool mask = k0 + DQ_KEYS > Sk || (causal && k0 + DQ_KEYS - 1 > qw0 + off);
      uint32_t sa[DQ_KEYS / 16][4];
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 2; j += 2) {
        const int r = (j >> 1) & 1;
        const int qpos = row0 + 8 * r;
        float ds2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * (j / 4) + cq + e;
          float p = exp2f(sc[j + e] * scale_log2 - lse2[r]);
          if (mask && (kpos >= Sk || (causal && kpos > qpos + off))) p = 0.f;
          float d = dp[j + e];
          if constexpr (DROP) {
            const bool keep = ptt::hash_keep(seed, (uint32_t)bh, (uint32_t)qpos, (uint32_t)kpos,
                                             thresh);
            d = keep ? d * inv_keep : 0.f;
          }
          ds2[e] = p * (d - dl[r]) * scale;
        }
        sa[j / 8][(j % 8) / 2] = s9::pack2<T>(ds2[0], ds2[1]);  // ds in k's type (:520)
      }
      s9::fence_regs(acc);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_KEYS / 16; ++kk) {
        const uint64_t bk = s9::desc_mn(k_addr + kk * 2048u, L::KV_HALF);
        s9::wgmma_rs<D, T>(acc, sa[kk], bk, 1);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(acc);
      s9::mbar_arrive(&empty[s]);
    }

    const long q_step = (long)H * D;
    T* db = dq + (long)b * Sq * q_step + (long)h * D + cq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos >= Sq) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int i = 4 * c + 2 * r;
        *reinterpret_cast<uint32_t*>(db + (long)qpos * q_step + 8 * c) =
            s9::pack2<T>(acc[i], acc[i + 1]);
      }
    }
  }
}

template <typename T, int D>
int launch_dq(const Args& a) {
  namespace s9 = ptt::sm90;
  CUtensorMap mq, mk, mv, mdo;
  int rc = s9::encode_bshd<T>(&mq, a.q, a.B, a.Sq, a.H, D, DQ_ROWS);
  if (rc == 0) rc = s9::encode_bshd<T>(&mdo, a.dout, a.B, a.Sq, a.H, D, DQ_ROWS);
  if (rc == 0) rc = s9::encode_bshd<T>(&mk, a.k, a.B, a.Sk, a.Hkv, D, DQ_KEYS);
  if (rc == 0) rc = s9::encode_bshd<T>(&mv, a.v, a.B, a.Sk, a.Hkv, D, DQ_KEYS);
  if (rc != 0) return rc;
  auto kern = a.use_drop ? flash_bwd_dq_tc_kernel<T, D, true> : flash_bwd_dq_tc_kernel<T, D, false>;
  const int smem = DqLayout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.Sq + DQ_ROWS - 1) / DQ_ROWS);
  kern<<<grid, NT, smem, a.stream>>>(mq, mk, mv, mdo, a.lse, a.delta,
                                     static_cast<T*>(a.o0), a.Sq, a.Sk, a.H, a.Hkv,
                                     a.causal, a.scale, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace tc

// variant 0: the CUDA-core kernels; 1: the tensor-core kernels (bf16 or
// f16, D 64 or 128; anything else is refused). The caller chooses.
template <bool DKDV>
int dispatch(int dtype, int variant, const Args& a) {
  if (a.D < 1 || a.D > 256 || a.Hkv < 1 || a.H % a.Hkv != 0 || a.Sq < 1 || a.Sk < 1 ||
      (a.causal && a.Sk < a.Sq))
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if ((dtype != ptt::kBF16 && dtype != ptt::kF16) || (a.D != 64 && a.D != 128))
      return (int)cudaErrorInvalidValue;
    if (dtype == ptt::kF16) {
      if (DKDV) return a.D == 64 ? tc::launch_dkdv<__half, 64>(a) : tc::launch_dkdv<__half, 128>(a);
      return a.D == 64 ? tc::launch_dq<__half, 64>(a) : tc::launch_dq<__half, 128>(a);
    }
    if (DKDV)
      return a.D == 64 ? tc::launch_dkdv<__nv_bfloat16, 64>(a)
                       : tc::launch_dkdv<__nv_bfloat16, 128>(a);
    return a.D == 64 ? tc::launch_dq<__nv_bfloat16, 64>(a) : tc::launch_dq<__nv_bfloat16, 128>(a);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == ptt::kF32) return dispatch_d<float, DKDV>(a);
  if (dtype == ptt::kBF16) return dispatch_d<__nv_bfloat16, DKDV>(a);
  if (dtype == ptt::kF16) return dispatch_d<__half, DKDV>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes by paddle_tpu_torch/ops/kernels/build.py).
// Returns a cudaError_t code; 0 means the launch was accepted. lse and
// delta are f32 [B, H, Sq]; every other tensor is contiguous [B, S, H(kv), D]
// of `dtype`. `variant` is the caller's choice of kernel (ops/attention.py
// kernel_variant): 0 CUDA cores, 1 bf16/f16 tensor cores.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int dtype, int B,
                                int Sq, int Sk, int H, int Hkv, int D, int causal, float scale,
                                int use_drop, unsigned int seed, unsigned int thresh,
                                float inv_keep, int variant, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dq,
         nullptr, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed, thresh, inv_keep,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, variant, a);
}

extern "C" int ptt_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int dtype, int B, int Sq, int Sk, int H, int Hkv, int D,
                                  int causal, float scale, int use_drop, unsigned int seed,
                                  unsigned int thresh, float inv_keep, int variant,
                                  void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dk,
         dv, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed, thresh, inv_keep,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, variant, a);
}
