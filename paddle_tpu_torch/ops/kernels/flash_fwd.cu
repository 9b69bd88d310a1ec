// Flash attention forward for Hopper (sm_90a), paddle layout [B, S, H, D].
//
// Replaces: paddle_tpu/ops/pallas.py `_flash_fwd_impl` (pallas_call at
// :465, kernel body `_fwd_kernels` :370) -- online softmax over K blocks,
// bottom-right-aligned causal mask, native GQA, in-kernel position-hash
// dropout, out plus f32 logsumexp.
//
// Two variants compute the same function; ops/attention.py
// `kernel_variant` picks one on dtype and head_dim alone and passes it in.
//
// bf16 or f16 at head_dim 64 or 128: the tensor-core kernel (namespace tc
// below; its design note is there; one template over the element type,
// whose wgmma, register packing and tensor maps take f16 as they take bf16). TMA streams K/V tiles into a ring that a
// producer warp keeps full; both products run on wgmma with f32
// accumulators in registers; the online softmax runs on the accumulator
// fragments; p goes to the storage type in registers as the A operand of P.V.
//
// f32, and bf16 or f16 at any other head_dim (<= 256): the CUDA-core kernel. One
// CTA of 256 threads per (b*h, 64-row q tile); the K loop runs inside the
// CTA and the online-softmax state lives in registers (acc, 4 rows x D/16
// columns per thread) and shared memory (m, l, alpha per row). Q, K and V
// tiles are widened to f32 in shared memory, so products are exact and
// sums f32. f32 stays here: the tensor cores would take it as TF32.
//
// Both: the TPU kernel walks K blocks as a sequential grid axis with its
// state in VMEM; here the K loop runs inside the CTA. p is rounded to the
// storage type before P.V, as the JAX kernel and its reference do
// (pallas.py:413-415, :361). q head h reads kv head h / (H / Hkv). Ragged
// Sq/Sk tails are masked (out-of-range keys leave the softmax;
// out-of-range query rows are never stored). Under `causal` key k is
// visible to query i iff k <= i + (Sk - Sq); tiles wholly past the last
// visible key are skipped.
//
// Bound on this card: at long S the work is 4*Sq*Sk*D flops per head
// (half that causal) against Sq*D + 2*Sk*D elements moved, so it is
// bound by operations: 989 TFLOP/s of bf16 tensor-core peak (0.139 ms at
// the training shape, S4096 H32/8 D128 causal). The CUDA-core kernel
// reaches about 1/50 of that (7.03 ms there); the tensor-core kernel
// puts every product on wgmma and keeps the score tile out of shared and
// device memory, which is what its design does about operations and
// bytes: 0.32-0.34 ms there on the H100 (~2.4x the bound; PyTorch's
// scaled_dot_product_attention takes 0.25 ms).

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;    // query rows per CTA
constexpr int BK = 32;    // keys per inner tile
constexpr int NT = 256;   // threads: 16 x 16, each owns 4 rows

template <int DMAX>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DMAX + 1) + (size_t)BK * (DMAX + 1) + (size_t)BK * DMAX +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int D,
    int causal, float scale, int use_drop, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int QS = DMAX + 1;  // padded row strides: conflict-free column walks
  constexpr int KS = DMAX + 1;
  constexpr int PS = BK + 1;
  constexpr int CPT = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * DMAX;
  float* m_s = Ps + BQ * PS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int off = Sk - Sq;  // causal bottom-right alignment

  const long q_step = (long)H * D;
  const long kv_step = (long)Hkv * D;
  const T* qb = q + (long)b * Sq * q_step + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_step + (long)hk * D;
  const T* vb = v + (long)b * Sk * kv_step + (long)hk * D;

  for (int i = tid; i < BQ * DMAX; i += NT) {
    const int r = i / DMAX, c = i % DMAX;
    float x = 0.f;
    if (q0 + r < Sq && c < D) x = ptt::to_f32(qb[(long)(q0 + r) * q_step + c]);
    Qs[r * QS + c] = x;
  }
  if (tid < BQ) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int n_k = (Sk + BK - 1) / BK;
  int kmax = n_k;
  if (causal) {
    const int last_visible = off + q0 + BQ - 1;  // >= 0: the wrapper rejects Sk < Sq
    kmax = min(n_k, last_visible / BK + 1);
  }
  __syncthreads();

  for (int kt = 0; kt < kmax; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int r = i / DMAX, c = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && c < D) {
        const long o = (long)(k0 + r) * kv_step + c;
        kx = ptt::to_f32(kb[o]);
        vx = ptt::to_f32(vb[o]);
      }
      Ks[r * KS + c] = kx;
      Vs[r * DMAX + c] = vx;
    }
    __syncthreads();

    // scores: rows ty*4+i, keys tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[tx * KS + d];
      const float k1v = Ks[(tx + 16) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty * 4 + i) * QS + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Ps[(ty * 4 + i) * PS + tx] = s[i][0] * scale;
      Ps[(ty * 4 + i) * PS + tx + 16] = s[i][1] * scale;
    }
    __syncthreads();

    // online softmax, one thread per row
    if (tid < BQ) {
      const int r = tid;
      const int qpos = q0 + r;
      float* pr = Ps + r * PS;
      const float m_old = m_s[r];
      float mx = m_old;
      for (int c = 0; c < BK; ++c) {
        const int kpos = k0 + c;
        float x = pr[c];
        if (kpos >= Sk) x = __int_as_float(0xff800000);  // -inf: leaves the softmax
        else if (causal && kpos > qpos + off) x = -1e30f;
        pr[c] = x;
        mx = fmaxf(mx, x);
      }
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        float p = expf(pr[c] - mx);
        sum += p;  // the normaliser is dropout-free
        if (use_drop) {
          const bool keep = ptt::hash_keep(seed, (uint32_t)bh, (uint32_t)qpos,
                                           (uint32_t)(k0 + c), thresh);
          p = keep ? p * inv_keep : 0.f;
        }
        pr[c] = ptt::round_to<T>(p);
      }
      const float alpha = expf(m_old - mx);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = mx;
      a_s[r] = alpha;
    }
    __syncthreads();

    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = Vs[c * DMAX + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* ob = out + (long)b * Sq * q_step + (long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < D) ob[(long)(q0 + r) * q_step + c] = ptt::from_f32<T>(acc[i][j] / l);
    }
  }
  if (tid < BQ && q0 + tid < Sq) lse[(long)bh * Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int Hkv, int D, int causal, float scale, int use_drop, uint32_t seed,
           uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_floats<DMAX>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk,
                                   H, Hkv, D, causal, scale, use_drop, seed, thresh, inv_keep);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
               int Sk, int H, int Hkv, int D, int causal, float scale, int use_drop,
               uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed,
                         thresh, inv_keep, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed,
                          thresh, inv_keep, stream);
  return launch<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed,
                        thresh, inv_keep, stream);
}

// ---------------------------------------------------------------------------
// bf16/f16 tensor-core variant (head_dim 64 or 128)
// ---------------------------------------------------------------------------
//
// One CTA of 288 threads per (b*h, 128-row q tile), the heaviest causal
// tiles launched first (blockIdx.y counts q tiles from the last). Warp 8
// is the producer: one lane loads the Q tile once and streams 128-key K
// and V tiles through a 2-stage ring with TMA (zero-filled past S), each
// stage on a "full" mbarrier (TMA bytes) and an "empty" one (256 consumer
// arrivals). Warps 0-7 are two consumer warpgroups of 64 q rows each.
// Per key tile a warpgroup runs S = Q.K^T as D/16 wgmma m64n128k16 from
// shared memory into f32 registers, then the online softmax on the
// accumulator fragments: each thread owns two rows, reduces its own
// columns and finishes max and sum with two shuffles inside its quad.
// Masking code runs only on tiles that cross the causal diagonal or Sk;
// the dropout hash takes each element's own (row, column). p (dropout-
// free in the normaliser, scaled after it, as the CUDA-core variant) is
// rounded to the storage type (bf16 or f16) in registers, where it is
// already the A fragment of O += P.V (8 register-A wgmma m64nDk16, V read
// MN-major). O, m and l stay in registers; the epilogue writes O in the
// storage type and the f32 lse. ptxas holds
// the CTA to 168 registers a thread; O (64 at D = 128), S (64) and P (32)
// fit without spilling. 64-key tiles and a third stage were slower.

namespace tc {

constexpr int BQ = 128;  // q rows per CTA: two warpgroups of 64
constexpr int BK = 128;  // keys per stage
constexpr int STAGES = 2;
constexpr int NT = 288;  // 8 consumer warps + 1 producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int Q_HALF = BQ * 128;   // bytes of one 64-column half of the Q tile
  static constexpr int KV_HALF = BK * 128;  // ... of a K or V tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int causal, float scale_log2,
    int use_drop, uint32_t seed, uint32_t thresh, float inv_keep) {
  using L = Layout<D>;
  namespace s9 = ptt::sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = s9::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tile first
  const int off = Sk - Sq;                           // causal bottom-right alignment
  const int n_k = (Sk + BK - 1) / BK;
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kmax = causal ? min(n_k, (last_row + off) / BK + 1) : n_k;
  // the warp index through a shuffle from lane 0, so the compiler knows it
  // is uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    s9::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      s9::mbar_init(&full[s], 1);
      s9::mbar_init(&empty[s], 256);
    }
    s9::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      s9::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < D / 64; ++c)
        s9::tma_load_4d(smem + c * L::Q_HALF, &tm_q, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < kmax; ++i) {
        const int s = i % STAGES;
        s9::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        s9::mbar_arrive_expect_tx(&full[s], 2 * L::KV_BYTES);
        uint8_t* kd = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* vd = smem + L::V_OFF + s * L::KV_BYTES;
        for (int c = 0; c < D / 64; ++c) {
          s9::tma_load_4d(kd + c * L::KV_HALF, &tm_k, &full[s], 64 * c, hk, i * BK, b);
          s9::tma_load_4d(vd + c * L::KV_HALF, &tm_v, &full[s], 64 * c, hk, i * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread rows r and r + 8 of them, columns 8 j + cq + {0, 1} of a tile
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg + (warp % 4) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const uint32_t q_addr = s9::smem_u32(smem) + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  s9::mbar_wait(q_full, 0);
  for (int i = 0; i < kmax; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    s9::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t k_addr = s9::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
    const uint32_t v_addr = s9::smem_u32(smem + L::V_OFF + s * L::KV_BYTES);

    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    s9::fence_regs(sc);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = (kk / 4) * 1u, sub = (kk % 4) * 32u;
      s9::wgmma_ss<BK, T>(sc, s9::desc_k(q_addr + at * L::Q_HALF + sub),
                       s9::desc_k(k_addr + at * L::KV_HALF + sub), kk > 0);
    }
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(sc);

    // online softmax in the log2 domain on the fragments
    const bool mask = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + 64 * wg + off);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      float x = sc[j] * scale_log2;
      if (mask) {
        const int kpos = k0 + 8 * (j / 4) + cq + (j & 1);
        const int qpos = row0 + 8 * ((j >> 1) & 1);
        if (kpos >= Sk || (causal && kpos > qpos + off)) x = -INFINITY;
      }
      sc[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with nothing visible yet
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 2; j += 2) {
      float p2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = ((j + e) >> 1) & 1;
        float p = exp2f(sc[j + e] - base[r]);
        sum[r] += p;  // the normaliser is dropout-free
        if (use_drop) {
          const int kpos = k0 + 8 * (j / 4) + cq + e;
          const bool keep = ptt::hash_keep(seed, (uint32_t)bh, (uint32_t)(row0 + 8 * r),
                                           (uint32_t)kpos, thresh);
          p = keep ? p * inv_keep : 0.f;
        }
        p2[e] = p;
      }
      pa[j / 8][(j % 8) / 2] = s9::pack2<T>(p2[0], p2[1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    s9::fence_regs(o);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = s9::desc_mn(v_addr + kk * 2048u, L::KV_HALF);
      s9::wgmma_rs<D, T>(o, pa[kk], dv, 1);
    }
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(o);
    s9::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long q_step = (long)H * D;
  T* ob = out + (long)b * Sq * q_step + (long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= Sq) continue;
    T* orow = ob + (long)qpos * q_step + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint32_t v2 = s9::pack2<T>(o[4 * c + 2 * r] / l[r], o[4 * c + 2 * r + 1] / l[r]);
      *reinterpret_cast<uint32_t*>(orow + 8 * c) = v2;
    }
    if (lane % 4 == 0) lse[(long)bh * Sq + qpos] = m[r] * LN2 + logf(l[r]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int Hkv, int causal, float scale, int use_drop, uint32_t seed,
           uint32_t thresh, float inv_keep, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = ptt::sm90::encode_bshd<T>(&mq, q, B, Sq, H, D, BQ);
  if (rc == 0) rc = ptt::sm90::encode_bshd<T>(&mk, k, B, Sk, Hkv, D, BK);
  if (rc == 0) rc = ptt::sm90::encode_bshd<T>(&mv, v, B, Sk, Hkv, D, BK);
  if (rc != 0) return rc;
  auto kern = flash_fwd_tc_kernel<T, D>;
  const int smem = Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(mq, mk, mv, static_cast<T*>(out), lse, Sq, Sk, H,
                                   Hkv, causal, scale * LOG2E, use_drop, seed, thresh, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C interface (bound with ctypes by paddle_tpu_torch/ops/kernels/build.py).
// `variant` is the caller's choice of kernel (ops/attention.py
// kernel_variant): 0 the CUDA-core kernel (f32, bf16 or f16, D <= 256),
// 1 the tensor-core kernel (bf16 or f16, D 64 or 128; anything else is
// refused).
// Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int dtype, int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                             float scale, int use_drop, unsigned int seed, unsigned int thresh,
                             float inv_keep, int variant, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 || (causal && Sk < Sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (variant == 1) {
    if ((dtype != ptt::kBF16 && dtype != ptt::kF16) || (D != 64 && D != 128))
      return (int)cudaErrorInvalidValue;
    if (dtype == ptt::kF16)
      return D == 64 ? tc::launch<__half, 64>(q, k, v, out, l, B, Sq, Sk, H, Hkv, causal, scale,
                                              use_drop, seed, thresh, inv_keep, s)
                     : tc::launch<__half, 128>(q, k, v, out, l, B, Sq, Sk, H, Hkv, causal, scale,
                                               use_drop, seed, thresh, inv_keep, s);
    return D == 64 ? tc::launch<__nv_bfloat16, 64>(q, k, v, out, l, B, Sq, Sk, H, Hkv, causal,
                                                   scale, use_drop, seed, thresh, inv_keep, s)
                   : tc::launch<__nv_bfloat16, 128>(q, k, v, out, l, B, Sq, Sk, H, Hkv, causal,
                                                    scale, use_drop, seed, thresh, inv_keep, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == ptt::kF32)
    return dispatch_d<float>(q, k, v, out, l, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop, seed,
                             thresh, inv_keep, s);
  if (dtype == ptt::kBF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, l, B, Sq, Sk, H, Hkv, D, causal, scale,
                                     use_drop, seed, thresh, inv_keep, s);
  if (dtype == ptt::kF16)
    return dispatch_d<__half>(q, k, v, out, l, B, Sq, Sk, H, Hkv, D, causal, scale, use_drop,
                              seed, thresh, inv_keep, s);
  return (int)cudaErrorInvalidValue;
}
