// Paged attention for Hopper (sm_90a): Q >= 1 queries per sequence against
// a KV pool [N, bs, Hkv, D] addressed through a block table.
//
// Replaces: paddle_tpu/ops/pallas.py `_paged_extend_impl` (pallas_call at
// :1013, kernel body `_paged_attn_kernel` :909) -- decode (Q == 1),
// extend and speculative verify (Q > 1, each query with its own causal
// frontier), GQA rows packed query-major (row r is query r / group of
// group slot r % group), optional int8 pages dequantized with
// q * (scale * (1/127)) in f32, p rounded to the V type (bf16 pages) or
// kept f32 (f32 and int8 pages) before P.V.
//
// Bound on this card: decode reads every cached K/V byte once for a
// handful of flops per byte, so it is bound by memory bandwidth: the K/V
// bytes of each row's pages up to its frontier over 3.35 TB/s. What the
// design does about it:
//
// 1. Split-K over the context (flash-decoding). The grid is (split, kv
//    head, b x row tile); a split is `split_pages` pages of the block
//    table, planned on the host from shapes alone (ops.attention.
//    paged_split_plan: about 3 CTAs an SM on the mma path; no read-back of
//    the frontiers). At the serving shape (B 8, Hkv 8, a 128-page table)
//    that is 7 splits, 448 CTAs for 132 SMs, so every SM streams and a long
//    row no longer sets the time alone. A CTA whose split starts past the
//    largest frontier among its rows exits after its first reads, which it
//    issues together (block table, frontiers, q).
// 2. Rings of K/V tiles in shared memory filled with 16-byte cp.async
//    copies, `stages` deep (PTT_PAGED_STAGES at most): the next tiles' loads
//    are in flight while the current one is scored. K/V stay in their
//    storage type in shared memory (bf16, f32, or int8 with their f32
//    scales), rows padded by 16 bytes so row reads do not conflict. Every q
//    row of the kv head shares each tile: the pool is read once per kv head.
// 3. bf16 pages at head dim 64 or 128 (the serving path) take the mma path:
//    each of the 4 warps streams its own 16-slot tiles of the split (tiles
//    w, w + 4, ...) through its own ring, with no barrier of the CTA, and
//    runs S = Q.K^T and P.V as mma.sync m16n8k16 (bf16 in, f32 out) from
//    ldmatrix, the q rows (at most 16 a CTA) held as A fragments for the
//    whole split; the online softmax runs on the accumulator fragments (a
//    row's slots in 4 lanes), and p, rounded to bf16, is the A fragment of
//    P.V. The warps' (m, l, acc) are combined in a fixed order at the end.
//    Every other case (f32 or int8 pages, other head dims) takes the
//    CUDA-core path: one ring of 32-slot tiles for the CTA, a warp per q
//    row and a lane per slot for the scores (4 partial sums; int8 widened
//    by a byte permute and one add, its scales applied per slot), a thread
//    per (row, 4 columns) for P.V.
// 4. A merge pass. With more than one split, each CTA writes its rows'
//    f32 partials (m, l and the unnormalised accumulator) to a workspace,
//    and `paged_attn_merge_kernel` combines, for each output row, the
//    splits that start at or before that row's frontier, in split order:
//    the result is the same bit for bit from run to run (no atomics). The
//    merge never reads a split that begins past the row's frontier: such
//    a partial is either masked whole (m = -1e30 with p = 1 on its masked
//    slots) or was never written (its CTA exited). It is launched as a
//    programmatic dependent (griddepcontrol), so its launch overlaps the
//    split kernel's tail. With one split the CTA writes the output itself
//    and no merge launches.
//
// The masking keeps the reference's -1e30 (slots past a row's frontier
// add exactly 0 once the row's max is a real score, which the split that
// holds slot 0 of the merge's range always gives). Padded table entries
// point at the reserved page 0, so every slot read is valid memory; V rows
// past the split's end are zeroed in the ring, since p = 0 times stale
// memory could be NaN.

#include "common.cuh"

#include <math.h>

#include <type_traits>

#ifndef PTT_PAGED_STAGES
#define PTT_PAGED_STAGES 2  // ring depth at most (the launcher takes fewer if they do not fit)
#endif

namespace {

constexpr int NT = 128;  // 4 warps
constexpr int NWARP = NT / 32;
constexpr int MAX_STAGES = PTT_PAGED_STAGES;
static_assert(MAX_STAGES >= 2 && MAX_STAGES <= 8, "PTT_PAGED_STAGES must be in [2, 8]");
constexpr int MMA_ROWS = 16;  // q rows a CTA of the mma path holds at most (one m16 tile)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of this thread's copy groups are pending (n <= N)
template <int N> __device__ __forceinline__ void cp_async_wait_upto(int n) {
  if constexpr (N == 0) {
    cp_async_wait<0>();
  } else {
    if (n >= N) cp_async_wait<N>();
    else cp_async_wait_upto<N - 1>(n);
  }
}

// four 8x8 b16 matrices from shared memory (lane l gives row l % 8 of matrix l / 8)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// byte k of a word of int8 values as f32, given u = word ^ 0x80808080: the
// byte under the exponent of 2^23 (one byte permute), less 2^23 + 128. Exact,
// and full rate where an int-to-float conversion runs at an eighth of it.
__device__ __forceinline__ float i8_to_f32(uint32_t u, int k) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.0f;
}

// the storage elements of one 16-byte copy as f32 (int8: the integers; the
// caller applies the scale)
template <typename T> __device__ __forceinline__ void widen16(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k) f[4 * i + k] = i8_to_f32(u, k);
    }
  }
}

// four consecutive storage elements as f32 (int8: the integers)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  return make_float4(i8_to_f32(u, 0), i8_to_f32(u, 1), i8_to_f32(u, 2), i8_to_f32(u, 3));
}

// Shared-memory layout of one CTA, in bytes from the dynamic window. The
// CUDA-core path: one ring of `tile`-slot stages for the CTA, and per q row
// its f32 query, accumulator and probabilities. The mma path: a ring of
// 16-slot stages for each warp, and the q rows padded to 16 in bf16 (its
// accumulators live in registers; the end of the split reuses the rings
// to combine the warps).
struct Layout {
  int rows, tile, stages, D, elem, quant, mma, split_slots;
  __host__ __device__ int kstride() const { return D * elem + 16; }  // padded slot row
  __host__ __device__ int rows_pad() const { return mma ? 16 : rows; }
  __host__ __device__ size_t stage_bytes() const {
    return 2 * (size_t)tile * kstride() + (quant ? 2 * (size_t)tile * sizeof(float) : 0);
  }
  __host__ __device__ size_t ring_bytes() const {
    const size_t ring = (size_t)(mma ? NWARP : 1) * stages * stage_bytes();
    const size_t merge = mma ? (size_t)NWARP * 16 * (D + 2) * sizeof(float) : 0;
    return ring > merge ? ring : merge;
  }
  __host__ __device__ size_t q_off() const { return ring_bytes(); }
  __host__ __device__ size_t acc_off() const {
    return q_off() + (size_t)rows_pad() * (mma ? D * 2 + 16 : D * sizeof(float));
  }
  __host__ __device__ size_t p_off() const {
    return acc_off() + (mma ? 0 : (size_t)rows * D * sizeof(float));
  }
  __host__ __device__ size_t stat_off() const {
    return p_off() + (mma ? 0 : (size_t)rows * tile * sizeof(float));
  }
  __host__ __device__ size_t slot_off() const { return stat_off() + 4 * (size_t)rows_pad() * 4; }
  __host__ __device__ size_t bytes() const { return slot_off() + (size_t)split_slots * 4; }
};

// TQ: query/output type. TKV: page storage type. TP: the type p is rounded
// to before P.V (bf16 for bf16 pages; f32 for f32 and int8 pages). DMMA:
// the head dim of the mma path (bf16 pages, D 64 or 128, at most 16 q rows
// a CTA), 0 for the CUDA-core path.
//
// Workspace (n_splits > 1): acc [B*Q*H, n_splits, D] f32, then (m, l)
// [B*Q*H, n_splits, 2] f32, output row o = (b * Q + query) * H + q head.
template <typename TQ, typename TKV, typename TP, int DMMA>
__global__ void __launch_bounds__(NT) paged_attn_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const float* __restrict__ ksc, const float* __restrict__ vsc,
    const int* __restrict__ block_tables, const int* __restrict__ q_positions,
    TQ* __restrict__ out, float* __restrict__ ws, int Q, int H, int Hkv, int D, int bs, int M,
    int split_pages, int n_splits, int rows_per_cta, int row_tiles, int tile, int stages,
    float scale) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr bool MMA = DMMA > 0;
  constexpr int VEC = 16 / sizeof(TKV);  // storage elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  // the merge kernel (a programmatic dependent) may launch now; it waits
  // for this whole grid before it reads anything
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, hk = blockIdx.y;
  const int b = blockIdx.z / row_tiles, row0 = (blockIdx.z % row_tiles) * rows_per_cta;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = H / Hkv;
  const int rows = min(rows_per_cta, Q * group - row0);
  const int* qp = q_positions + (long)b * Q;

  const int split_slots = split_pages * bs;
  const int start = split * split_slots;
  const int len_max = min(split_slots, M * bs - start);  // the split's slots in the table
  const Layout L{rows, tile, stages, D, (int)sizeof(TKV), QUANT, MMA, split_slots};
  const int rows_pad = L.rows_pad(), kstride = L.kstride();
  const size_t stage_bytes = L.stage_bytes();
  unsigned char* ring = smem;
  unsigned char* q_s = smem + L.q_off();                      // mma: bf16 rows; else f32
  float* acc_s = reinterpret_cast<float*>(smem + L.acc_off());  // CUDA-core path
  float* p_s = reinterpret_cast<float*>(smem + L.p_off());      // CUDA-core path
  float* m_s = reinterpret_cast<float*>(smem + L.stat_off());
  float* l_s = m_s + rows_pad;
  float* a_s = l_s + rows_pad;
  int* fr_s = reinterpret_cast<int*>(a_s + rows_pad);
  int* slot_s = reinterpret_cast<int*>(smem + L.slot_off());
  const int qstride = D * 2 + 16;  // mma path: bf16 q row, padded

  // The prologue. The split's block-table entries and (mma path) the q rows
  // are loaded into registers alongside the frontiers: a CTA whose split
  // begins past every row's frontier exits on the frontiers alone, and the
  // others pay one memory latency before their first K/V copy.
  constexpr int PRE = 4;  // slots a thread resolves from registers (more: a second pass)
  int page[PRE];
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int i = tid + u * NT;
    page[u] = i < len_max ? block_tables[(long)b * M + (start + i) / bs] : 0;
  }
  constexpr int QREG = MMA ? MMA_ROWS * DMMA / NT : 1;  // q values a thread stages (mma path)
  float qv[QREG];
  if constexpr (MMA) {
#pragma unroll
    for (int k = 0; k < QREG; ++k) {
      const int i = tid + k * NT, r = i / DMMA, c = i % DMMA;
      qv[k] = 0.f;  // the padding rows: zero
      if (r < rows) {
        const int qi = (row0 + r) / group, h = hk * group + (row0 + r) % group;
        qv[k] = ptt::to_f32(q[(((long)b * Q + qi) * H + h) * DMMA + c]);
      }
    }
  }
  // this CTA's slots: the split's, up to the largest frontier of its rows
  int frontier = 0;
  for (int j = row0 / group; j <= (row0 + rows - 1) / group; ++j) frontier = max(frontier, qp[j]);
  const int end = min(start + len_max, frontier + 1);
  if (start >= end) return;  // the split begins past every row's frontier (uniform in the CTA)

  for (int r = tid; r < rows_pad; r += NT) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
    a_s[r] = 0.f;
    fr_s[r] = r < rows ? qp[(row0 + r) / group] : 0;
  }
  if constexpr (MMA) {
#pragma unroll
    for (int k = 0; k < QREG; ++k) {
      const int i = tid + k * NT;
      reinterpret_cast<__nv_bfloat16*>(q_s + (i / DMMA) * qstride)[i % DMMA] =
          __float2bfloat16_rn(qv[k]);
    }
  } else {
    for (int i = tid; i < rows * D; i += NT) {
      const int r = i / D, c = i % D;
      const int qi = (row0 + r) / group, h = hk * group + (row0 + r) % group;
      reinterpret_cast<float*>(q_s)[i] = ptt::to_f32(q[(((long)b * Q + qi) * H + h) * D + c]);
      acc_s[i] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < PRE; ++u) {  // the pool slot of each cache position of the split
    const int i = tid + u * NT;
    if (i < len_max) slot_s[i] = page[u] * bs + (start + i) % bs;
  }
  for (int i = tid + PRE * NT; i < len_max; i += NT) {
    const int pos = start + i;
    slot_s[i] = block_tables[(long)b * M + pos / bs] * bs + pos % bs;
  }
  __syncthreads();
  const int len = end - start;

  auto out_row = [&](int r) -> long {
    const int qi = (row0 + r) / group, h = hk * group + (row0 + r) % group;
    return ((long)b * Q + qi) * H + h;
  };
  // this CTA's result for row r (of its rows), column c: the output itself
  // with one split, else the unnormalised partial and (m, l)
  auto emit = [&](int r, int c, float acc, float m, float l) {
    const long o = out_row(r);
    if (n_splits == 1) {
      out[o * D + c] = ptt::from_f32<TQ>(acc / l);
    } else {
      ws[(o * n_splits + split) * D + c] = acc;
      if (c == 0) {
        float* ml = ws + (long)gridDim.z / row_tiles * Q * H * n_splits * D;
        ml[(o * n_splits + split) * 2] = m;
        ml[(o * n_splits + split) * 2 + 1] = l;
      }
    }
  };

  if constexpr (MMA) {
    // Each warp streams its own 16-slot tiles of the split (tiles w, w + 4,
    // ...) through its own ring, with its own online softmax over the (at
    // most 16) q rows on the tensor cores: no barrier of the CTA until the
    // warps are combined at the end.
    constexpr int CPR = DMMA / 8;  // 16-byte copies per slot row
    constexpr int KS = DMMA / 16;  // k16 steps of q.k
    constexpr int NTD = DMMA / 8;  // 8-column n tiles of the output
    const int g = lane >> 2, t4 = lane & 3;
    unsigned char* wring = ring + (size_t)warp * stages * stage_bytes;
    const int nwt = (len + 15) / 16;  // the CTA's 16-slot tiles
    const int my_tiles = nwt > warp ? (nwt - warp + NWARP - 1) / NWARP : 0;
    auto wissue = [&](int i) {
      const int j = warp + NWARP * i;
      if (i < my_tiles) {
        const int s0 = j * 16, n = min(16, len - s0);
        unsigned char* ks = wring + (size_t)(i % stages) * stage_bytes;
        unsigned char* vs = ks + 16 * kstride;
        for (int k = lane; k < n * CPR; k += 32) {
          const int s = k / CPR, c = k % CPR;
          const long off = ((long)slot_s[s0 + s] * Hkv + hk) * DMMA + c * 8;
          cp_async16(ks + s * kstride + c * 16, kp + off);
          cp_async16(vs + s * kstride + c * 16, vp + off);
        }
        // V rows past the split's end: zero (p = 0 times stale memory could be NaN)
        for (int k = lane; k < (16 - n) * CPR; k += 32)
          *reinterpret_cast<uint4*>(vs + (n + k / CPR) * kstride + (k % CPR) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      cp_async_commit();
    };

    uint32_t qa[KS][4];  // the q rows as mma A fragments, for the whole split
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(qa[ks], q_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * qstride + (16 * ks + 8 * (lane >> 4)) * 2);
    const int fr0 = fr_s[g], fr1 = fr_s[g + 8];  // the frontiers of this thread's rows g, g + 8
    float o[NTD][4];
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // l: this thread's part of the row sum

    for (int i = 0; i < stages - 1; ++i) wissue(i);
    for (int i = 0; i < my_tiles; ++i) {
      cp_async_wait_upto<MAX_STAGES - 2>(stages - 2);
      __syncwarp();  // every lane's copies of tile i landed; every lane is done with tile i - 1
      wissue(i + stages - 1);
      const unsigned char* ks = wring + (size_t)(i % stages) * stage_bytes;
      const unsigned char* vs = ks + 16 * kstride;
      const int s0 = start + (warp + NWARP * i) * 16, n = min(16, end - s0);

      // S = Q.K^T, two 8-slot n tiles (accumulator: rows g, g + 8; slots 2 t4, 2 t4 + 1)
      float c[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
        const unsigned char* kb = ks + (8 * nt + (lane & 7)) * kstride + (lane >> 3) * 16;
#pragma unroll
        for (int k0 = 0; k0 < DMMA; k0 += 32) {
          uint32_t kf[4];
          ldsm_x4(kf, kb + k0 * 2);
          mma_bf16(c[nt], qa[k0 / 16], kf[0], kf[1]);
          mma_bf16(c[nt], qa[k0 / 16 + 1], kf[2], kf[3]);
        }
      }
      // the online softmax on the fragments: a row's 16 slots lie in its 4 lanes
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = 8 * nt + 2 * t4 + (e & 1);
          const float x = slot >= n ? -INFINITY
                          : s0 + slot > (e < 2 ? fr0 : fr1) ? -1e30f : c[nt][e] * scale;
          c[nt][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      uint32_t pa[4];  // p rounded to bf16: the A fragment of P.V
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float p0 = expf(c[nt][0] - mx0), p1 = expf(c[nt][1] - mx0);
        const float p2 = expf(c[nt][2] - mx1), p3 = expf(c[nt][3] - mx1);
        l0 = l0 * (nt == 0 ? al0 : 1.f) + p0 + p1;
        l1 = l1 * (nt == 0 ? al1 : 1.f) + p2 + p3;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0, p1), hi = __floats2bfloat162_rn(p2, p3);
        pa[2 * nt] = *reinterpret_cast<const uint32_t*>(&lo);
        pa[2 * nt + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      // O = O * alpha + P.V
      const unsigned char* vb =
          vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kstride + 8 * (lane >> 4) * 2;
#pragma unroll
      for (int j = 0; j < NTD / 2; ++j) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vb + 32 * j);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float* acc = o[2 * j + h2];
          acc[0] *= al0;
          acc[1] *= al0;
          acc[2] *= al1;
          acc[3] *= al1;
          mma_bf16(o[2 * j + h2], pa, vf[2 * h2], vf[2 * h2 + 1]);
        }
      }
    }
    cp_async_wait<0>();
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    __syncthreads();  // every warp is done with its ring: combine the warps there

    float* wo = reinterpret_cast<float*>(ring);  // [warp][16 rows][D]
    float* wml = wo + NWARP * 16 * DMMA;         // [warp][16 rows][m, l]
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      float* w0 = wo + (warp * 16 + g) * DMMA + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(w0) = make_float2(o[nt][0], o[nt][1]);
      *reinterpret_cast<float2*>(w0 + 8 * DMMA) = make_float2(o[nt][2], o[nt][3]);
    }
    if (t4 == 0) {
      wml[(warp * 16 + g) * 2] = m0;
      wml[(warp * 16 + g) * 2 + 1] = l0;
      wml[(warp * 16 + g + 8) * 2] = m1;
      wml[(warp * 16 + g + 8) * 2 + 1] = l1;
    }
    __syncthreads();
    for (int i = tid; i < rows * DMMA; i += NT) {  // the warps in a fixed order
      const int r = i / DMMA, c = i % DMMA;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, wml[(w * 16 + r) * 2]);
      float acc = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        const float wt = expf(wml[(w * 16 + r) * 2] - mx);
        l = fmaf(wt, wml[(w * 16 + r) * 2 + 1], l);
        acc = fmaf(wt, wo[(w * 16 + r) * DMMA + c], acc);
      }
      emit(r, c, acc, mx, l);
    }
    return;
  } else {
    const int ntiles = (len + tile - 1) / tile;
    const int cpr = D / VEC;  // 16-byte copies per slot row
    // copy tile t of the split into the ring: one commit group per call
    // (empty past the last tile, so the wait counts stay uniform); the V
    // rows past the split's end are zeroed, since p = 0 times stale memory
    // could be NaN
    auto issue = [&](int t) {
      if (t < ntiles) {
        const int s0 = t * tile, n = min(tile, len - s0);
        unsigned char* ks = ring + (size_t)(t % stages) * stage_bytes;
        unsigned char* vs = ks + (size_t)tile * kstride;
        if (NT % cpr == 0) {  // a fixed 16-byte column of the row per thread
          const int c = tid % cpr;
          for (int s = tid / cpr; s < n; s += NT / cpr) {
            const long off = ((long)slot_s[s0 + s] * Hkv + hk) * D + (long)c * VEC;
            cp_async16(ks + s * kstride + c * 16, kp + off);
            cp_async16(vs + s * kstride + c * 16, vp + off);
          }
        } else {
          for (int i = tid; i < n * cpr; i += NT) {
            const int s = i / cpr, c = i - s * cpr;
            const long off = ((long)slot_s[s0 + s] * Hkv + hk) * D + (long)c * VEC;
            cp_async16(ks + s * kstride + c * 16, kp + off);
            cp_async16(vs + s * kstride + c * 16, vp + off);
          }
        }
        for (int i = tid; i < (tile - n) * cpr; i += NT)
          *reinterpret_cast<uint4*>(vs + (n + i / cpr) * kstride + (i % cpr) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        if constexpr (QUANT) {
          float* sc = reinterpret_cast<float*>(vs + (size_t)tile * kstride);
          for (int s = tid; s < n; s += NT) {
            const long slot = (long)slot_s[s0 + s] * Hkv + hk;
            cp_async4(sc + s, ksc + slot);
            cp_async4(sc + tile + s, vsc + slot);
          }
        }
      }
      cp_async_commit();
    };

    for (int t = 0; t < stages - 1; ++t) issue(t);
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait_upto<MAX_STAGES - 2>(stages - 2);  // tile t has landed (this thread's copies)
      __syncthreads();  // ... everyone's; and every thread is done with tile t - 1
      issue(t + stages - 1);  // into the stage tile t - 1 held

      const unsigned char* ks = ring + (size_t)(t % stages) * stage_bytes;
      const unsigned char* vs = ks + (size_t)tile * kstride;
      const float* sc = reinterpret_cast<const float*>(vs + (size_t)tile * kstride);
      const int s0 = start + t * tile, n = min(tile, end - s0);

      // scores and the online softmax: a warp per row, a lane per slot, the
      // dot product over 4 partial sums; int8: the scales applied per slot
      const float kmul = (QUANT && lane < n) ? sc[lane] * (1.0f / 127.0f) : 1.f;
      const float vmul = (QUANT && lane < n) ? sc[tile + lane] * (1.0f / 127.0f) : 0.f;
      for (int r = warp; r < rows; r += NWARP) {
        float x = -INFINITY;  // slots past the tile: no part of the softmax
        if (lane < n) {
          const TKV* krow = reinterpret_cast<const TKV*>(ks + lane * kstride);
          const float* qr = reinterpret_cast<const float*>(q_s) + r * D;
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int c = 0; c < D; c += VEC) {
            float kf[VEC];
            widen16<TKV>(*reinterpret_cast<const uint4*>(krow + c), kf);
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + c + j);
              d4[0] = fmaf(qv.x, kf[j], d4[0]);
              d4[1] = fmaf(qv.y, kf[j + 1], d4[1]);
              d4[2] = fmaf(qv.z, kf[j + 2], d4[2]);
              d4[3] = fmaf(qv.w, kf[j + 3], d4[3]);
            }
          }
          const float dot = ((d4[0] + d4[1]) + (d4[2] + d4[3])) * kmul;
          x = s0 + lane > fr_s[r] ? -1e30f : dot * scale;
        }
        const float m_old = m_s[r];
        const float mx = warp_max(fmaxf(m_old, x));
        const float p = expf(x - mx);
        const float sum = warp_sum(p);
        // int8: the slot's V scale folded into p (0 past the tile)
        if (lane < tile) p_s[r * tile + lane] = QUANT ? p * vmul : ptt::round_to<TP>(p);
        if (lane == 0) {
          const float alpha = expf(m_old - mx);
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = mx;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

      // P.V: a thread per (row, 4 columns), the accumulator in shared
      // memory; p and V are 0 past the split's end
      const int c4n = D / 4, n4 = (n + 3) & ~3;
      for (int i = tid; i < rows * c4n; i += NT) {
        const int r = i / c4n, c = (i - r * c4n) * 4;
        float4* accp = reinterpret_cast<float4*>(acc_s + r * D + c);
        float4 a = *accp;
        const float alpha = a_s[r];
        a.x *= alpha;
        a.y *= alpha;
        a.z *= alpha;
        a.w *= alpha;
        const float* pr = p_s + r * tile;
        const TKV* vcol = reinterpret_cast<const TKV*>(vs) + c;
        for (int s = 0; s < n4; s += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + s);
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 v = load4(vcol + (size_t)(s + u) * kstride / sizeof(TKV));
            a.x = fmaf(pp[u], v.x, a.x);
            a.y = fmaf(pp[u], v.y, a.y);
            a.z = fmaf(pp[u], v.z, a.z);
            a.w = fmaf(pp[u], v.w, a.w);
          }
        }
        *accp = a;
      }
    }
    cp_async_wait<0>();  // only empty groups remain
    __syncthreads();
    for (int i = tid; i < rows * D; i += NT) {
      const int r = i / D;
      emit(r, i - r * D, acc_s[i], m_s[r], l_s[r]);
    }
  }
}

// A thread per 4 output columns: the splits that start at or before the
// row's frontier, weighted by exp(m_s - max m), in split order. Launched
// as a programmatic dependent of the split kernel: its CTAs may start
// while the split kernel's last CTAs run, and wait for all of its writes
// before reading the workspace.
template <typename TQ>
__global__ void __launch_bounds__(NT) paged_attn_merge_kernel(
    const float* __restrict__ ws, const int* __restrict__ q_positions, TQ* __restrict__ out,
    long rows_total, int H, int D, int split_slots, int n_splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long i = ((long)blockIdx.x * NT + threadIdx.x) * 4;
  if (i >= rows_total * D) return;
  const long o = i / D;
  const int c = (int)(i - o * D);
  const int frontier = max(q_positions[o / H], 0);
  const int ns = min(n_splits, frontier / split_slots + 1);
  const float* ml = ws + rows_total * n_splits * D + o * n_splits * 2;
  const float* acc = ws + o * n_splits * D + c;
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < ns; ++s) {
    const float w = expf(ml[2 * s] - mx);
    const float4 x = *reinterpret_cast<const float4*>(acc + (long)s * D);
    l = fmaf(w, ml[2 * s + 1], l);
    a.x = fmaf(w, x.x, a.x);
    a.y = fmaf(w, x.y, a.y);
    a.z = fmaf(w, x.z, a.z);
    a.w = fmaf(w, x.w, a.w);
  }
  out[i] = ptt::from_f32<TQ>(a.x / l);
  out[i + 1] = ptt::from_f32<TQ>(a.y / l);
  out[i + 2] = ptt::from_f32<TQ>(a.z / l);
  out[i + 3] = ptt::from_f32<TQ>(a.w / l);
}

template <typename TQ, typename TKV, typename TP, int DMMA>
int launch(const void* q, const void* kp, const void* vp, const float* ksc, const float* vsc,
           const int* bt, const int* qpos, void* out, float* ws, int B, int Q, int H, int Hkv,
           int D, int bs, int M, int split_pages, int rows_per_cta, float scale,
           cudaStream_t stream) {
  const int rows = Q * (H / Hkv);
  if (split_pages < 1 || split_pages > M || rows_per_cta < 1 || rows_per_cta > rows)
    return (int)cudaErrorInvalidValue;
  if (DMMA > 0 && rows_per_cta > MMA_ROWS) return (int)cudaErrorInvalidValue;
  const int n_splits = (M + split_pages - 1) / split_pages;
  if (n_splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int row_tiles = (rows + rows_per_cta - 1) / rows_per_cta;
  if ((long)B * row_tiles > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the widest tile (the mma path: 16-slot tiles a warp), then the deepest
  // ring, that fit beside the rows
  Layout L{rows_per_cta, 32, MAX_STAGES, D, (int)sizeof(TKV),
           (int)std::is_same<TKV, int8_t>::value, DMMA > 0, split_pages * bs};
  bool fits = false;
  for (int tile = DMMA > 0 ? 16 : 32; tile >= (DMMA > 0 ? 16 : 8) && !fits; tile /= 2)
    for (int st = MAX_STAGES; st >= 2 && !fits; --st) {
      L.tile = tile;
      L.stages = st;
      fits = L.bytes() <= (size_t)smem_max;
    }
  if (!fits) return (int)cudaErrorInvalidValue;
  const size_t smem = L.bytes();
  auto kern = paged_attn_split_kernel<TQ, TKV, TP, DMMA>;
  static int smem_set = 48 * 1024;  // per instantiation: the opt-in already granted
  if ((int)smem > smem_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_max;
  }
  dim3 grid(n_splits, Hkv, B * row_tiles);
  kern<<<grid, NT, smem, stream>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
                                   static_cast<const TKV*>(vp), ksc, vsc, bt, qpos,
                                   static_cast<TQ*>(out), ws, Q, H, Hkv, D, bs, M, split_pages,
                                   n_splits, rows_per_cta, row_tiles, L.tile, L.stages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const long rows_total = (long)B * Q * H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows_total * D / 4 + NT - 1) / NT));
  cfg.blockDim = dim3(NT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_attn_merge_kernel<TQ>, (const float*)ws, qpos,
                                 static_cast<TQ*>(out), rows_total, H, D, split_pages * bs,
                                 n_splits);
}

// the mma path for bf16 pages at head dim 64 or 128; the CUDA-core path
// for every other page type and head dim
template <typename TQ, typename TKV, typename TP>
int dispatch(const void* q, const void* kp, const void* vp, const float* ksc, const float* vsc,
             const int* bt, const int* qpos, void* out, float* ws, int B, int Q, int H, int Hkv,
             int D, int bs, int M, int split_pages, int rows_per_cta, float scale,
             cudaStream_t stream) {
  if ((D * sizeof(TKV)) % 16 != 0) return (int)cudaErrorInvalidValue;  // 16-byte row copies
  if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
    if (D == 128)
      return launch<TQ, TKV, TP, 128>(q, kp, vp, ksc, vsc, bt, qpos, out, ws, B, Q, H, Hkv, D,
                                      bs, M, split_pages, rows_per_cta, scale, stream);
    if (D == 64)
      return launch<TQ, TKV, TP, 64>(q, kp, vp, ksc, vsc, bt, qpos, out, ws, B, Q, H, Hkv, D, bs,
                                     M, split_pages, rows_per_cta, scale, stream);
  }
  return launch<TQ, TKV, TP, 0>(q, kp, vp, ksc, vsc, bt, qpos, out, ws, B, Q, H, Hkv, D, bs, M,
                                split_pages, rows_per_cta, scale, stream);
}

}  // namespace

// C interface (bound with ctypes by paddle_tpu_torch/ops/kernels/build.py).
// q/out [B, Q, H, D]; pages [N, bs, Hkv, D]; scales [N, bs, Hkv] f32 or
// null; block_tables [B, M] int32; q_positions [B, Q] int32; workspace
// B * Q * H * n_splits * (D + 2) f32 with n_splits = ceil(M / split_pages),
// or null when that is 1; rows_per_cta of the Q * H / Hkv rows of a
// (b, kv head) in one CTA. Returns a cudaError_t code; 0 means the
// launches were accepted.
extern "C" int ptt_paged_attn(const void* q, const void* k_pages, const void* v_pages,
                              const void* k_scales, const void* v_scales,
                              const void* block_tables, const void* q_positions, void* out,
                              void* workspace, int q_dtype, int kv_dtype, int B, int Q, int H,
                              int Hkv, int D, int bs, int M, int split_pages, int rows_per_cta,
                              float scale, void* stream) {
  if (D < 4 || Hkv < 1 || H % Hkv != 0 || Q < 1 || bs < 1 || M < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* bt = static_cast<const int*>(block_tables);
  const int* qp = static_cast<const int*>(q_positions);
  float* ws = static_cast<float*>(workspace);
  if (kv_dtype == ptt::kI8) {
    if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
    if (q_dtype == ptt::kF32)
      return dispatch<float, int8_t, float>(q, k_pages, v_pages, ks, vs, bt, qp, out, ws, B, Q, H,
                                          Hkv, D, bs, M, split_pages, rows_per_cta, scale, s);
    if (q_dtype == ptt::kBF16)
      return dispatch<__nv_bfloat16, int8_t, float>(q, k_pages, v_pages, ks, vs, bt, qp, out, ws,
                                                  B, Q, H, Hkv, D, bs, M, split_pages,
                                                  rows_per_cta, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != q_dtype || ks != nullptr) return (int)cudaErrorInvalidValue;
  if (q_dtype == ptt::kF32)
    return dispatch<float, float, float>(q, k_pages, v_pages, nullptr, nullptr, bt, qp, out, ws, B,
                                       Q, H, Hkv, D, bs, M, split_pages, rows_per_cta, scale, s);
  if (q_dtype == ptt::kBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, bt, qp, out, ws, B, Q, H, Hkv, D, bs, M,
        split_pages, rows_per_cta, scale, s);
  return (int)cudaErrorInvalidValue;
}
