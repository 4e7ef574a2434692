// K1: non-causal attention for the vision towers.
//
// Replaces videollama2_tpu/ops/encoder_attention.py::encoder_attention
// (Pallas `_kernel`): q/k/v [B, S, H, D] bf16 with equal head counts, given
// as strided views (the towers slice them out of the fused qkv projection),
// S <= 1024, a key-column mask from valid_len (-1e30 for masked keys, so a
// row with valid_len 0 returns mean(v) over all S keys), fp32 scores and
// softmax state, bf16 products with fp32 accumulation, bf16 output.
//
// What bounds it on the H100: at CLIP-L's chunk [128, 577, 16, 64] the two
// products are 4 * S^2 * D FLOPs per head against 4 * S * D * 2 bytes of
// q/k/v/out, ~290 FLOPs a byte, so it sits at the tensor-core ridge (the
// bytes bound by a hair); at SigLIP's [128, 729, 16, 72] (computed at a
// zero-padded 80) the operations bound it. Either way the tensor cores set
// the pace, and what keeps a kernel from it is the work around the
// products: the loads and barriers, and the softmax (one exponential a
// score on the 16-a-clock special-function unit, a max, a sum, a rescale).
// The design answers each:
//
// - 128 query rows a block, 4 warps of 32 rows (two m16 tiles each), on
//   mma.sync.m16n8k16 with ldmatrix: every K/V fragment a warp loads feeds
//   two products, and every K/V byte brought into shared memory feeds 128
//   query rows. At S 577 the grid is 5 query tiles x 16 heads x B frames; a
//   warp whose rows all lie past S skips the products.
// - An asynchronous ring of kStages K/V stages in dynamic shared memory,
//   filled with 16-byte cp.async copies that take the strided, ragged rows
//   as they are (rows past S and head-dim lanes past D are zero-filled by
//   the copy): tile kt + 1 is in flight while tile kt is multiplied. Q
//   stays in shared memory and is re-read with ldmatrix each key tile,
//   which keeps registers for the two 32-row accumulators (~220-240
//   registers a thread: two blocks an SM).
// - The softmax (tower_softmax.cuh, shared with K10) runs in the log2
//   domain: the maxima on the raw scores and one FMA by scale * log2(e)
//   inside each exponent (ex2.approx); only a tile that reaches past
//   valid_len is masked element by element; a tail tile with at most 16 or
//   32 counting keys runs 16- or 32-key products (S 577 = 9 * 64 + 1); the
//   running maxima move, and the accumulators are rescaled, only when a
//   row's maximum rises more than 2^8 above them; each thread keeps partial
//   row sums that the quad reduces at the end.
//
// Measured on an H100 (chip_smoke.py, PERF.md): faster than PyTorch's
// FlashAttention-2 backend of scaled_dot_product_attention at both shapes,
// slower than its default cuDNN backend, whose Hopper kernel runs the
// products on wgmma; a wgmma variant of this kernel (cp.async into the
// interleaved core-matrix layout, two warpgroups of 64 rows, synchronous
// or with Q K^T of the next tile in flight) measured slower than this one.
#include "attention_tile.cuh"
#include "cp_async.cuh"
#include "tower_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vl2::cp_async16;
using vl2::cp_async_commit;
using vl2::cp_async_wait;
using vl2::kMaskedScore;
using vl2_tower::kBlockK;
using vl2_tower::key_tiles;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;                          // m16 row tiles a warp
constexpr int kRowsPerWarp = kMT * 16;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows a block
constexpr int kStages = 2;                      // K/V tiles in the ring

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;                 // contiguous [B, S, H, D]
  const int* valid_len;    // [B], or nullptr (= S)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int S, H, D;
  float scale_log2;        // softmax scale * log2(e)
};

// Dynamic shared memory (bf16 elements): the Q tile, then kStages stages of
// a K tile and a V tile. Rows are padded by 8 elements so that every
// ldmatrix phase hits 8 distinct 16-byte bank groups.
template <int DK>
struct Smem {
  static constexpr int kRow = DK + 8;
  static constexpr int kQ = kBlockQ * kRow;
  static constexpr int kTile = kBlockK * kRow;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBytes = (kQ + kStages * kStage) * 2;
};

// Issue the copies of `rows` rows of D bf16 (row stride `row_stride`
// elements) into a [ROWS, DK + 8] shared tile; rows past `rows` and columns
// [D, DK) are zero-filled by the copy (source size 0).
template <int DK, int ROWS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long row_stride,
                                                int rows, int D) {
  constexpr int kChunks = DK / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < (ROWS * kChunks + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (ROWS * kChunks % kThreads != 0 && idx >= ROWS * kChunks) break;
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool ok = r < rows && c * 8 < D;
    cp_async16(dst + r * Smem<DK>::kRow + c * 8,
               ok ? src + r * row_stride + c * 8 : src, ok);
  }
}

// The A fragment of row tile mt, k16 chunk kc, of this warp's query rows.
template <int DK>
__device__ __forceinline__ void load_q(uint32_t (&qa)[4], const bf16* qs,
                                       int mt, int kc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  vl2::ldsm_x4(qa[0], qa[1], qa[2], qa[3],
               qs + (warp * kRowsPerWarp + mt * 16 + (lane & 7) +
                     ((lane >> 3) & 1) * 8) * Smem<DK>::kRow +
                   kc * 16 + (lane >> 4) * 8);
}

// One warp's online-softmax step over the first kNs * 8 keys of the key
// tile [k0, k0 + 64) staged in ks/vs (the whole tile, or a tail tile's
// first 16 or 32 keys when no key past them counts) for its kMT m16 row
// tiles (this thread's rows lane / 4 and lane / 4 + 8 of each). m_run is
// kept in the log2 domain.
template <int DK, int kNs>
__device__ __forceinline__ void tile_step(
    const bf16* qs, const bf16* ks, const bf16* vs,
    float (&acc)[kMT][DK / 8][4], float (&m_run)[kMT][2],
    float (&l_run)[kMT][2], int k0, int valid, int S, float scale_log2) {
  constexpr int kRow = Smem<DK>::kRow;
  constexpr int kKc = DK / 16;      // k16 chunks over the head dim
  constexpr int kNo = DK / 8;       // n8 output tiles over the head dim
  const int lane = threadIdx.x % 32;

  // S = Q K^T: kMT * 16 rows x kNs * 8 keys a warp; each K fragment feeds
  // every row tile.
  float s[kMT][kNs][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kNs; ++n)
      s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
    uint32_t qa[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) load_q<DK>(qa[mt], qs, mt, kc);
#pragma unroll
    for (int np = 0; np < kNs / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      vl2::ldsm_x4(b0, b1, b2, b3,
                   ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kRow +
                       kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        vl2::mma_bf16(s[mt][2 * np], qa[mt], b0, b1);
        vl2::mma_bf16(s[mt][2 * np + 1], qa[mt], b2, b3);
      }
    }
  }

  vl2_tower::online_softmax<kMT, kNs>(s, acc, m_run, l_run, k0, valid, S,
                                      scale_log2);

  // acc += P V: two n8 score tiles are the A fragment of one k16 chunk, so
  // P never leaves registers; each V fragment feeds every row tile.
#pragma unroll
  for (int kc = 0; kc < kNs / 2; ++kc) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) vl2_tower::p_fragment(s[mt], kc, a[mt]);
#pragma unroll
    for (int dp = 0; dp < kNo / 2; ++dp) {
      uint32_t b0, b1, b2, b3;
      vl2::ldsm_x4_trans(b0, b1, b2, b3,
                         vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kRow +
                             dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        vl2::mma_bf16(acc[mt][2 * dp], a[mt], b0, b1);
        vl2::mma_bf16(acc[mt][2 * dp + 1], a[mt], b2, b3);
      }
    }
  }
}

// One block: query rows [blockIdx.x * 128, +128) of head blockIdx.y in
// batch row blockIdx.z.
template <int DK>
__global__ void __launch_bounds__(kThreads)
    encoder_attention_pipelined_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Smem<DK>;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + L::kQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int valid = p.valid_len ? p.valid_len[b] : p.S;
  valid = valid < 0 ? 0 : (valid > p.S ? p.S : valid);
  const int n_tiles = key_tiles(p.S, valid);
  const int key_end = valid > 0 ? valid : p.S;
  const bf16* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + h * p.v_sh;

  auto load_kv = [&](int tile) {
    bf16* st = ring + (tile % kStages) * L::kStage;
    const int k0 = tile * kBlockK, rows = min(kBlockK, p.S - k0);
    load_rows_async<DK, kBlockK>(st, kbase + k0 * p.k_ss, p.k_ss, rows, p.D);
    load_rows_async<DK, kBlockK>(st + L::kTile, vbase + k0 * p.v_ss, p.v_ss,
                                 rows, p.D);
  };

  // The Q tile is the first copy group; the ring's first kStages - 1 tiles
  // follow, one group each (empty groups past the last tile keep the count).
  load_rows_async<DK, kBlockQ>(qs, p.q + b * p.q_sb + q0 * p.q_ss +
                                       h * p.q_sh,
                               p.q_ss, min(kBlockQ, p.S - q0), p.D);
  cp_async_commit();
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < n_tiles) load_kv(tile);
    cp_async_commit();
  }

  float acc[kMT][DK / 8][4];
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = kMaskedScore;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }
  const bool active = q0 + warp * kRowsPerWarp < p.S;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's did, and tile kt - 1's stage is free
    if (kt + kStages - 1 < n_tiles) load_kv(kt + kStages - 1);
    cp_async_commit();
    const int stage = kt % kStages;
    const bf16* st = ring + stage * L::kStage;
    if (!active) continue;
    // keys of this tile that count: those below valid_len, or, with
    // valid_len 0, every key below S
    const int k0 = kt * kBlockK, ns = vl2_tower::score_tiles(key_end - k0);
    if (ns == 2)
      tile_step<DK, 2>(qs, st, st + L::kTile, acc, m_run, l_run, k0, valid,
                       p.S, p.scale_log2);
    else if (ns == 4)
      tile_step<DK, 4>(qs, st, st + L::kTile, acc, m_run, l_run, k0, valid,
                       p.S, p.scale_log2);
    else
      tile_step<DK, kBlockK / 8>(qs, st, st + L::kTile, acc, m_run, l_run,
                                 k0, valid, p.S, p.scale_log2);
  }
  cp_async_wait<0>();
  if (!active) return;

  // out = acc / l for this thread's four rows; head-dim lanes past D and
  // rows past S are not stored.
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = vl2_tower::inverse_row_sum(l_run[mt][r]);
      const int row = q0 + warp * kRowsPerWarp + mt * 16 + (lane >> 2) + r * 8;
      if (row >= p.S) continue;
      bf16* out = p.o + ((long long)(b * p.S + row) * p.H + h) * p.D;
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        const int d = n * 8 + 2 * t;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
              acc[mt][n][2 * r] * inv, acc[mt][n][2 * r + 1] * inv);
      }
    }
}

template <int DK>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  auto kernel = encoder_attention_pipelined_kernel<DK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DK>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, B);
  kernel<<<grid, kThreads, Smem<DK>::kBytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers; strides are in elements; the last axis of q/k/v is contiguous
// and every row starts on a 16-byte boundary.
extern "C" int vl2_encoder_attention(
    const void* q, const void* k, const void* v, void* o,
    const int* valid_len, int B, int S, int H, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.valid_len = valid_len;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.S = S; p.H = H; p.D = D;
  p.scale_log2 = scale * vl2_tower::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch<64>(p, B, st));
  if (D == 72) return static_cast<int>(launch<80>(p, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
