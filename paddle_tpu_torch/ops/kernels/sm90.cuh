// Hopper (sm_90a) building blocks of the tensor-core flash kernels:
// mbarriers, TMA tile loads through a tensor map, wgmma descriptors and
// the bf16 and f16 wgmma instructions with f32 accumulators in registers
// (sm90_wgmma.cuh, once per type).
//
// Shared-memory tiles. TMA writes each tile of rows x D 16-bit values (bf16 or f16) as D / 64
// column halves; a half is `rows` lines of 128 bytes (64 values) in the
// 128-byte swizzle, and starts on a 1024-byte boundary. wgmma reads the
// same bytes through a descriptor:
//   K-major operand (the reduction runs along a row: Q, K, V, dO in
//     S = Q.K^T, dP = dO.V^T): 8-row groups 1024 bytes apart (SBO); the
//     k-th 16-value step of a half starts 32 * k bytes into it.
//   MN-major operand (the reduction runs down the rows: V in P.V, dO and
//     Q in dV = P^T.dO, dK = dS^T.Q, K in dQ = dS.K), read with the
//     transpose bit: 8-row groups 1024 bytes apart (SBO), the second
//     64-column half LBO bytes after the first; the k-th 16-row step
//     starts 2048 * k bytes in.
//
// wgmma m64nNk16 accumulator fragment (the layout every kernel here
// relies on; the same for bf16 and f16): thread t of a warpgroup (warp w = t / 32, lane l) holds
// d[i], i < N / 2, at row 16 w + l / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (l % 4) + (i % 2). The 16-bit A fragment of a register-A
// wgmma (four 32-bit registers per 16-wide k step) has the same layout,
// so accumulator pairs (d[8k + 2j], d[8k + 2j + 1]), j < 4, packed low
// then high, are the A registers of k step k.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared-memory window rounded up to a 1024-byte boundary
// (the 128-byte swizzle's period); the launch asks for 1024 bytes more
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed. A
// wait that outlasts 2^26 polls (~a second; a stage takes microseconds) is
// a pipeline deadlock: it traps, so the launch fails with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Moves registers between warpgroups (all four warps of one execute it):
// a producer warpgroup gives up registers it does not need, consumer
// warpgroups take them. The counts must fit the registers the CTA got at
// launch (threads x the kernel's register count).
template <uint32_t R> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <uint32_t R> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// descriptor fields: start address >> 4 (bits 0-13), LBO >> 4 (16-29),
// SBO >> 4 (32-45), layout 1 = 128-byte swizzle (62-63)
__device__ __forceinline__ uint64_t desc_encode(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}
// K-major operand at shared address `addr` (LBO unused by this layout)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc_encode(addr, 16, 1024); }
// MN-major operand at `addr`; its 64-column halves `half_bytes` apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t half_bytes) {
  return desc_encode(addr, half_bytes, 1024);
}

// two 16-bit values of type T packed into one 32-bit register, `lo` in the
// low half (round to nearest even)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

namespace bf16 {
#define PTT_WGMMA_TYPE "bf16"
#include "sm90_wgmma.cuh"
#undef PTT_WGMMA_TYPE
}  // namespace bf16
namespace f16 {
#define PTT_WGMMA_TYPE "f16"
#include "sm90_wgmma.cuh"
#undef PTT_WGMMA_TYPE
}  // namespace f16

// the instructions by width N (a compile-time constant) and element type T
// (__nv_bfloat16 or __half) of A and B; the accumulator is f32 for both
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N is 32, 64 or 128");
  if constexpr (std::is_same_v<T, __half>) {
    if constexpr (N == 32) f16::wgmma_ss_n32(d, da, db, acc);
    else if constexpr (N == 64) f16::wgmma_ss_n64(d, da, db, acc);
    else f16::wgmma_ss_n128(d, da, db, acc);
  } else {
    static_assert(std::is_same_v<T, __nv_bfloat16>, "wgmma_ss: T is __nv_bfloat16 or __half");
    if constexpr (N == 32) bf16::wgmma_ss_n32(d, da, db, acc);
    else if constexpr (N == 64) bf16::wgmma_ss_n64(d, da, db, acc);
    else bf16::wgmma_ss_n128(d, da, db, acc);
  }
}
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (std::is_same_v<T, __half>) {
    if constexpr (N == 64) f16::wgmma_rs_n64(d, a, db, acc);
    else f16::wgmma_rs_n128(d, a, db, acc);
  } else {
    static_assert(std::is_same_v<T, __nv_bfloat16>, "wgmma_rs: T is __nv_bfloat16 or __half");
    if constexpr (N == 64) bf16::wgmma_rs_n64(d, a, db, acc);
    else bf16::wgmma_rs_n128(d, a, db, acc);
  }
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous 16-bit (T: __nv_bfloat16 or __half) [B, S, Hh, D] tensor whose box is
// one head's `rows` x 64 columns, 128-byte swizzled: coordinates
// (column, head, row, batch). Rows past S read as zeros. The base must be
// 16-byte aligned (the driver refuses the map otherwise). Returns a
// cudaError_t code.
template <typename T>
inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int Hh, int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hh, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hh * D * 2,
                                 (cuuint64_t)S * Hh * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  constexpr CUtensorMapDataType dt = std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = fn(map, dt, 4, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace ptt
