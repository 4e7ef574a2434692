// K10: non-causal tower attention, two heads a block (the head-pair form).
//
// Replaces videollama2_tpu/ops/encoder_attention.py::_encoder_attention_packed
// (Pallas `_kernel_packed`), reached through
// encoder_attention(..., pack_pairs=True): q/k/v [B, S, H, D] bf16 with an
// even H, S <= 1024, a key-column mask from valid_len (-1e30 for masked
// keys), fp32 scores and softmax, bf16 output: the same function as K1
// (encoder_attention.cu), computed for heads 2p and 2p + 1 together.
//
// The Pallas kernel packed a head pair block-diagonally ([S, 2D] @ [2D, 2S]
// and [S, 2S] @ [2S, 2D]) only to fill the TPU's 128 MXU lanes with 64-wide
// heads; its zero blocks double the products. On Hopper a 64-wide head
// already fills mma.sync tiles, so the zero blocks are not carried over:
// each head's products stay its own. What a pair means here is the memory
// layout: in [B, S, H, D] heads 2p and 2p + 1 of a token are adjacent, so
// the pair's row is one contiguous 2D-element run (256 B at D 64, 288 B at
// D 72). One block takes (64-query tile, head pair, batch row) with 8 warps:
// each key/value tile of both heads is staged into shared memory by one
// vectorized pass over those runs (16 bytes a thread), the tile count and
// the key-column bound (valid_len) are taken once for both heads, and warps
// 0-3 run head 2p's online softmax while warps 4-7 run head 2p + 1's
// (attention_tile.cuh: the same tile step as K1, so both kernels round
// alike). D 72 (SigLIP) is computed at a zero-padded 80, as in K1.
//
// What bounds it on the H100: the same work as K1 (4 * S^2 * D FLOPs a head
// against 4 * S * D bytes, near the tensor-core ridge at tower shapes); a
// block stages 2 x 2 x 64 x (DK + 8) bf16 = 45 KB at DK 80, under the 48 KB
// of static shared memory. What limits this design is occupancy: a
// 256-thread block at ~130 registers a thread leaves room for one block an
// SM's 65,536 registers, so the kernel is bounded to two blocks an SM (128
// registers; at DK 80 ptxas spills 20 bytes), which on an H100 at 700 W
// took [128,729,16,72] from 7.19 to 3.82 ms. It stays slower than K1 (its
// 8 warps wait at each barrier for a load pass of twice the bytes, and two
// blocks an SM overlap less than K1's three): the tiles load synchronously,
// and an asynchronous load pipeline is the next step for both kernels.

#include "attention_tile.cuh"

namespace {

constexpr int kPairWarps = 2 * vl2::kWarps;  // one 4-warp group a head
constexpr int kPairThreads = kPairWarps * 32;

// Rows [0, rows) of a head pair into two [64, DK + 8] shared tiles (head
// 2p's, then head 2p + 1's): consecutive threads take consecutive 16-byte
// chunks of a token's pair run (src + r * row_stride + head * head_stride);
// head-dim columns [D, DK) and rows past `rows` are zero-filled.
template <int DK>
__device__ __forceinline__ void load_pair_tile(__nv_bfloat16* tile,
                                               const __nv_bfloat16* src,
                                               long long row_stride,
                                               long long head_stride,
                                               int rows, int D) {
  constexpr int kChunks = DK / 8;  // 16-byte chunks per head row
  constexpr int kRow = DK + 8;
  for (int idx = threadIdx.x; idx < vl2::kBlockK * 2 * kChunks;
       idx += kPairThreads) {
    const int r = idx / (2 * kChunks), c = idx % (2 * kChunks);
    const int head = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && cc * 8 < D)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride +
                                            head * head_stride + cc * 8);
    *reinterpret_cast<uint4*>(tile + (head * vl2::kBlockK + r) * kRow +
                              cc * 8) = val;
  }
}

template <int DK>
__global__ void __launch_bounds__(kPairThreads, 2)
    encoder_attention_pairs_kernel(vl2::AttnParams p) {
  constexpr int kTile = vl2::kBlockK * (DK + 8);
  __shared__ __align__(16) __nv_bfloat16 ks[2 * kTile];
  __shared__ __align__(16) __nv_bfloat16 vs[2 * kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int head = warp / vl2::kWarps, warp_row = warp % vl2::kWarps;
  const int q0 = blockIdx.x * vl2::kBlockQ, b = blockIdx.z;
  const int h0 = 2 * blockIdx.y;
  const int h = h0 + head;
  int valid = p.valid_len ? p.valid_len[b] : p.Sk;
  valid = valid < 0 ? 0 : (valid > p.Sk ? p.Sk : valid);

  // Both heads' Q tiles through the K buffer, into A fragments.
  load_pair_tile<DK>(ks, p.q + b * p.q_sb + q0 * p.q_ss + h0 * p.q_sh,
                     p.q_ss, p.q_sh, min(vl2::kBlockQ, p.Sq - q0), p.D);
  __syncthreads();
  uint32_t qf[DK / 16][4];
  vl2::load_q_fragments<DK>(qf, ks + head * kTile, warp_row);

  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {vl2::kMaskedScore, vl2::kMaskedScore};
  float l_run[2] = {0.f, 0.f};
  const int n_tiles = vl2::key_tiles<false>(p.Sk, valid, q0);
  const int row0 = q0 + warp_row * 16 + (lane >> 2);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * vl2::kBlockK;
    const int rows = min(vl2::kBlockK, p.Sk - k0);
    __syncthreads();  // both heads' warps are done with the previous tiles
    load_pair_tile<DK>(ks, p.k + b * p.k_sb + k0 * p.k_ss + h0 * p.k_sh,
                       p.k_ss, p.k_sh, rows, p.D);
    load_pair_tile<DK>(vs, p.v + b * p.v_sb + k0 * p.v_ss + h0 * p.v_sh,
                       p.v_ss, p.v_sh, rows, p.D);
    __syncthreads();
    vl2::softmax_tile_step<DK, false>(qf, ks + head * kTile,
                                      vs + head * kTile, acc, m_run, l_run,
                                      k0, row0, valid, p.Sk, p.scale);
  }
  vl2::store_rows<DK>(p, acc, m_run, l_run, row0, h, b);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers; strides are in elements; the last axis of q/k/v is contiguous;
// H is even (the wrapper checks it).
extern "C" int vl2_encoder_attention_pairs(
    const void* q, const void* k, const void* v, void* o,
    const int* valid_len, int B, int S, int H, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  if (H % 2) return static_cast<int>(cudaErrorInvalidValue);
  vl2::AttnParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = nullptr;
  p.valid_len = valid_len;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.B = B; p.Sq = S; p.Sk = S; p.Hq = H; p.Hkv = H; p.D = D;
  p.scale = scale;
  const dim3 grid((S + vl2::kBlockQ - 1) / vl2::kBlockQ, H / 2, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    encoder_attention_pairs_kernel<64><<<grid, kPairThreads, 0, st>>>(p);
  } else if (D == 72) {
    encoder_attention_pairs_kernel<80><<<grid, kPairThreads, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
