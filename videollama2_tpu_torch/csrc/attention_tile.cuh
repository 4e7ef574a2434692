// Shared core of the attention kernels: one thread block computes a 64-row
// query tile of one (batch, head) with an online softmax over 64-key tiles
// (encoder_attention.cu, flash_attention.cu), and the fragment helpers the
// backward kernels (flash_attention_bwd.cu) build their products from.
//
// Layout and numerics follow the JAX package's Pallas kernels: q/k/v are
// [B, S, H, D] bf16 with D contiguous, scores and softmax state (m, l, acc)
// are fp32, both products run on bf16 operands with fp32 accumulation, and a
// masked score is the finite -1e30, so a row whose every key is masked
// (valid_len == 0) returns mean(v) over all Sk keys, exactly like the plain
// version's softmax over an all -1e30 row.
//
// Tensor cores are driven with warp-level mma.sync.m16n8k16 (bf16 in, fp32
// out) and ldmatrix; each of the 4 warps owns 16 query rows. Tiles are loaded
// synchronously into padded shared memory (row stride D + 8 elements, which
// makes every ldmatrix phase hit 8 distinct 16-byte bank groups). wgmma, TMA
// and a load/compute pipeline are later work.
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

struct AttnParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;        // contiguous [B, Sq, Hq, D]
  float* lse;              // [B, Hq, Sq] per-row log-sum-exp, or nullptr
  const int* valid_len;    // [B] keys per batch row, or nullptr (= Sk)
  long long q_sb, q_ss, q_sh;  // element strides (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, Sq, Sk, Hq, Hkv, D;
  float scale;
};

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

// The A fragments of one warp's 16 query rows (rows [warp_row * 16, +16)
// of a [64, DK + 8] shared tile), held in registers for the key loop.
template <int DK>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[DK / 16][4],
                                                 const __nv_bfloat16* tile,
                                                 int warp_row) {
  constexpr int kRow = DK + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < DK / 16; ++kc) {
    const __nv_bfloat16* ptr =
        tile + (warp_row * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
        kc * 16 + (lane >> 4) * 8;
    ldsm_x4(qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3], ptr);
  }
}

// One warp's online-softmax step over the 64-key tile [k0, k0 + 64) staged
// in ks/vs ([64, DK + 8] each): scores for its 16 rows (this thread's rows
// row0 and row0 + 8), scale, mask (keys at or past `valid`, and, causal,
// above the diagonal, get the finite -1e30; tile padding past Sk is not a
// key at all), the (m, l) update and acc += P V.
template <int DK, bool kCausal>
__device__ __forceinline__ void softmax_tile_step(
    const uint32_t (&qf)[DK / 16][4], const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, float (&acc)[DK / 8][4], float (&m_run)[2],
    float (&l_run)[2], int k0, int row0, int valid, int Sk, float scale) {
  constexpr int kRow = DK + 8;
  constexpr int kKc = DK / 16;        // k16 chunks over the head dim
  constexpr int kNs = kBlockK / 8;    // n8 score tiles per key tile
  constexpr int kNo = DK / 8;         // n8 output tiles over the head dim
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;

  // S = Q K^T for 16 rows x 64 keys per warp.
  float s[kNs][4];
#pragma unroll
  for (int n = 0; n < kNs; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
    for (int np = 0; np < kNs / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      const __nv_bfloat16* ptr =
          ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kRow + kc * 16 +
          ((lane >> 3) & 1) * 8;
      ldsm_x4(b0, b1, b2, b3, ptr);
      mma_bf16(s[2 * np], qf[kc], b0, b1);
      mma_bf16(s[2 * np + 1], qf[kc], b2, b3);
    }
  }

  // Scale, mask, online softmax update (rows row0 and row0 + 8).
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int n = 0; n < kNs; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + n * 8 + 2 * t + (e & 1);
      const int row = row0 + (e >> 1) * 8;
      float x = s[n][e] * scale;
      bool keep = col < valid;
      if (kCausal) keep = keep && col <= row;
      x = keep ? x : kMaskedScore;
      if (col >= Sk) x = -INFINITY;  // tile padding: not a key at all
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = __expf(m_run[r] - mx[r]);
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int n = 0; n < kNs; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = __expf(s[n][e] - m_run[e >> 1]);
      s[n][e] = pe;
      rsum[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + rsum[r];
  }
#pragma unroll
  for (int n = 0; n < kNo; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }

  // acc += P V: the score accumulators of two n8 tiles are exactly the A
  // fragment of one k16 chunk, so P never leaves registers.
#pragma unroll
  for (int kc = 0; kc < kBlockK / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < kNo / 2; ++dp) {
      uint32_t b0, b1, b2, b3;
      const __nv_bfloat16* ptr =
          vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
          dp * 16 + (lane >> 4) * 8;
      ldsm_x4_trans(b0, b1, b2, b3, ptr);
      mma_bf16(acc[2 * dp], a, b0, b1);
      mma_bf16(acc[2 * dp + 1], a, b2, b3);
    }
  }
}

// out = acc / l for this thread's rows row0 and row0 + 8 of head h; rows
// past Sq and head-dim lanes past D are not stored. With an lse pointer,
// lane t == 0 of each quad (all four hold the same reduced m and l) also
// stores m + log(l): a fully masked row's m is the -1e30 fill, which
// absorbs log(count), so its lse is -1e30.
template <int DK>
__device__ __forceinline__ void store_rows(const AttnParams& p,
                                           const float (&acc)[DK / 8][4],
                                           const float (&m_run)[2],
                                           const float (&l_run)[2], int row0,
                                           int h, int b) {
  const int t = (threadIdx.x % 32) & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.Sq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + row] = m_run[r] + logf(l);
    const float inv = 1.f / l;
    __nv_bfloat16* out =
        p.o + ((long long)(b * p.Sq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < p.D)
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

// The number of 64-key tiles a query tile starting at q0 visits. Key tiles
// wholly past valid_len (and, causal, above the diagonal) would add
// exp(-1e30 - m) == 0 to every row: they are skipped. With valid_len == 0
// every row is fully masked and must visit all Sk keys to return mean(v),
// so nothing is skipped.
template <bool kCausal>
__device__ __forceinline__ int key_tiles(int Sk, int valid, int q0) {
  int n_tiles = (Sk + kBlockK - 1) / kBlockK;
  if (valid > 0) {
    n_tiles = min(n_tiles, (valid + kBlockK - 1) / kBlockK);
    if (kCausal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);
  }
  return n_tiles;
}

// One block: query rows [qtile * 64, +64) of head h in batch row b.
// ks/vs: shared tiles of kBlockK * (DK + 8) elements each.
template <int DK, bool kCausal>
__device__ __forceinline__ void attention_tile(const AttnParams& p, int qtile,
                                               int h, int b,
                                               __nv_bfloat16* ks,
                                               __nv_bfloat16* vs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qtile * kBlockQ;
  const int kvh = h / (p.Hq / p.Hkv);  // GQA: query head h reads kv h/rep
  int valid = p.valid_len ? p.valid_len[b] : p.Sk;
  valid = valid < 0 ? 0 : (valid > p.Sk ? p.Sk : valid);

  // Q tile through the K buffer into A fragments held for the whole loop.
  load_tile<DK>(ks, p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss,
                min(kBlockQ, p.Sq - q0), p.D);
  __syncthreads();
  uint32_t qf[DK / 16][4];
  load_q_fragments<DK>(qf, ks, warp);

  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kMaskedScore, kMaskedScore};
  float l_run[2] = {0.f, 0.f};
  const int n_tiles = key_tiles<kCausal>(p.Sk, valid, q0);
  const int row0 = q0 + warp * 16 + (lane >> 2);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const int rows = min(kBlockK, p.Sk - k0);
    __syncthreads();  // all warps are done reading the previous tiles
    load_tile<DK>(ks, p.k + b * p.k_sb + k0 * p.k_ss + kvh * p.k_sh, p.k_ss,
                  rows, p.D);
    load_tile<DK>(vs, p.v + b * p.v_sb + k0 * p.v_ss + kvh * p.v_sh, p.v_ss,
                  rows, p.D);
    __syncthreads();
    softmax_tile_step<DK, kCausal>(qf, ks, vs, acc, m_run, l_run, k0, row0,
                                   valid, p.Sk, p.scale);
  }
  store_rows<DK>(p, acc, m_run, l_run, row0, h, b);
}

}  // namespace vl2
