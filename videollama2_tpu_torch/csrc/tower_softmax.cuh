// The online softmax of the tower attention kernels, K1
// (encoder_attention.cu) and K10 (encoder_attention_pairs.cu), over the
// score fragments a thread holds after a tensor-core product: kMT row tiles
// of 16 (this thread's rows lane / 4 and lane / 4 + 8 of each, the layout of
// both an mma.sync m16n8 accumulator and a warp's share of a wgmma m64
// accumulator), kNs n8 key tiles of the 64-key tile [k0, k0 + 64).
//
// It runs in the log2 domain: the maxima are taken on the raw scores and
// the scale * log2(e) is folded into each exponent's FMA (ex2.approx); only
// a tile that reaches past valid_len is scaled and masked element by
// element (-1e30 for a masked key below S, so a row with valid_len 0
// returns mean(v) over all S keys; -inf for tile padding past S, which is
// not a key at all); the running maxima move, and the accumulators are
// rescaled, only when a row's maximum rises more than 2^kRescaleSlack above
// them; each thread keeps partial row sums that the quad reduces at the end.
//
// K1 calls the steps in order (online_softmax). K10 splits them around its
// asynchronous P V product: the maxima and exponents of tile kt are taken
// while the product of tile kt - 1 runs, and the accumulators are rescaled
// after it has landed.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"  // kMaskedScore, pack_bf16

namespace vl2_tower {

constexpr int kBlockK = 64;                  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kRescaleSlack = 8.f;         // log2 of the largest p

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Key tiles a block visits: those holding a valid key. Tiles wholly past
// valid_len would add exp2(-1e30 - m) == 0 to every row and are skipped;
// with valid_len == 0 every key is masked and all S keys are visited, so
// the row returns mean(v).
__device__ __forceinline__ int key_tiles(int S, int valid) {
  return ((valid > 0 ? min(valid, S) : S) + kBlockK - 1) / kBlockK;
}

// n8 key tiles of the product for a tile with `keys` counting keys (those
// below valid_len, or below S with valid_len 0): a tail tile with at most 16
// or 32 of them runs 16- or 32-key products (S 577 = 9 * 64 + 1).
__device__ __forceinline__ int score_tiles(int keys) {
  return keys <= 16 ? 2 : (keys <= 32 ? 4 : kBlockK / 8);
}

// Whether the first kNs * 8 keys of the tile at k0 reach past valid_len:
// then the tile is scaled and masked element by element.
template <int kNs>
__device__ __forceinline__ bool tile_masked(int k0, int valid) {
  return k0 + kNs * 8 > valid;
}

// Each row's maximum over the first kNs n8 tiles of s, in the log2 domain
// (masking s in place when `masked`), reduced over the quad into mx.
// Returns, for the whole warp, whether some row's maximum rose more than
// kRescaleSlack above its running maximum m_run.
template <int kMT, int kNs, int N>
__device__ __forceinline__ bool tile_maxima(float (&s)[kMT][N][4],
                                            float (&mx)[kMT][2],
                                            const float (&m_run)[kMT][2],
                                            bool masked, int k0, int valid,
                                            int S, float scale_log2) {
  static_assert(kNs <= N, "more score tiles than the fragment holds");
  const int t = (threadIdx.x % 32) & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    mx[mt][0] = mx[mt][1] = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[mt][n][e];
        if (masked) {
          x *= scale_log2;
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          if (col >= valid) x = col < S ? vl2::kMaskedScore : -INFINITY;
          s[mt][n][e] = x;
        }
        mx[mt][e >> 1] = fmaxf(mx[mt][e >> 1], x);
      }
  }
  bool grow = false;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = masked ? mx[mt][r] : mx[mt][r] * scale_log2;
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      mx[mt][r] = m;
      grow |= m > m_run[mt][r] + kRescaleSlack;
    }
  return __any_sync(0xffffffffu, grow);
}

// Moves the running maxima up to mx: the partial sums take the factor
// alpha now, the accumulators when rescale() is called.
template <int kMT>
__device__ __forceinline__ void move_maxima(const float (&mx)[kMT][2],
                                            float (&m_run)[kMT][2],
                                            float (&l_run)[kMT][2],
                                            float (&alpha)[kMT][2]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[mt][r], m_run[mt][r]);
      alpha[mt][r] = ex2(m_run[mt][r] - m);
      m_run[mt][r] = m;
      l_run[mt][r] *= alpha[mt][r];
    }
}

template <int kMT, int kNo>
__device__ __forceinline__ void rescale(float (&acc)[kMT][kNo][4],
                                        const float (&alpha)[kMT][2]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < kNo; ++n) {
        acc[mt][n][2 * r] *= alpha[mt][r];
        acc[mt][n][2 * r + 1] *= alpha[mt][r];
      }
}

// p = 2^(s * scale_log2 - m) in place (s already scaled when `masked`),
// added to this thread's partial row sums.
template <int kMT, int kNs, int N>
__device__ __forceinline__ void exponentiate(float (&s)[kMT][N][4],
                                             const float (&m_run)[kMT][2],
                                             float (&l_run)[kMT][2],
                                             bool masked, float scale_log2) {
  const float mul = masked ? 1.f : scale_log2;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[mt][n][e], mul, -m_run[mt][e >> 1]));
        s[mt][n][e] = pe;
        l_run[mt][e >> 1] += pe;  // this thread's columns; quad-summed last
      }
}

// The whole step for one key tile, in order: maxima, the rescale of the
// accumulators where a maximum moved, exponents.
template <int kMT, int kNs, int N, int kNo>
__device__ __forceinline__ void online_softmax(float (&s)[kMT][N][4],
                                               float (&acc)[kMT][kNo][4],
                                               float (&m_run)[kMT][2],
                                               float (&l_run)[kMT][2], int k0,
                                               int valid, int S,
                                               float scale_log2) {
  const bool masked = tile_masked<kNs>(k0, valid);
  float mx[kMT][2];
  if (tile_maxima<kMT, kNs>(s, mx, m_run, masked, k0, valid, S,
                            scale_log2)) {
    float alpha[kMT][2];
    move_maxima<kMT>(mx, m_run, l_run, alpha);
    rescale<kMT, kNo>(acc, alpha);
  }
  exponentiate<kMT, kNs>(s, m_run, l_run, masked, scale_log2);
}

// The A fragment of k16 chunk kc of P for one 16-row tile: the score
// accumulators of n8 tiles 2kc and 2kc + 1 are exactly it, so P never leaves
// registers.
template <int N>
__device__ __forceinline__ void p_fragment(const float (&s)[N][4], int kc,
                                           uint32_t (&a)[4]) {
  a[0] = vl2::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = vl2::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = vl2::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = vl2::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// The quad's sum of this thread's partial row sums, inverted for the
// output (a row that saw no key, l 0, divides by 1).
__device__ __forceinline__ float inverse_row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return 1.f / (l == 0.f ? 1.f : l);
}

}  // namespace vl2_tower
