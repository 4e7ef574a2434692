// The mma.sync fragment helpers (ldmatrix, m16n8k16 bf16 products, bf16
// packing) and the synchronous tile load that K8 (flash_attention_bwd.cu)
// builds its products from, and that K1 (encoder_attention.cu), the tower
// softmax (tower_softmax.cuh) and the decode matmuls (splitk_matmul.cuh,
// decode_matmul.cuh) share.
//
// Layout and numerics follow the JAX package's Pallas kernels: q/k/v are
// [B, S, H, D] bf16 with D contiguous, scores and softmax state are fp32,
// products run on bf16 operands with fp32 accumulation, and a masked score
// is the finite -1e30 (kMaskedScore), so a row whose every key is masked
// (valid_len == 0) returns mean(v) over all keys, exactly like the plain
// version's softmax over an all -1e30 row.
//
// Each of K8's 4 warps owns 16 rows; its tiles live in padded shared
// memory (row stride D + 8 elements, which makes every ldmatrix phase hit
// 8 distinct 16-byte bank groups).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vl2 {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block
constexpr int kBlockK = 64;           // keys per tile (== kBlockQ, see load)
constexpr float kMaskedScore = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of D bf16 (row stride `row_stride` elements, 16-byte
// aligned) into a [64, DK + 8] shared tile; columns [D, DK) and rows past
// `rows` are zero-filled, so padded keys score 0 before masking and padded
// head-dim lanes add nothing to either product.
template <int DK>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int D) {
  constexpr int kChunks = DK / 8;  // 16-byte chunks per row
  constexpr int kRow = DK + 8;
  for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c * 8 < D)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
    *reinterpret_cast<uint4*>(tile + r * kRow + c * 8) = val;
  }
}

}  // namespace vl2
