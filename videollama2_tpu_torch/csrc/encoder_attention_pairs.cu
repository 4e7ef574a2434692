// K10: non-causal tower attention, two heads a block (the head-pair form).
//
// Replaces videollama2_tpu/ops/encoder_attention.py::_encoder_attention_packed
// (Pallas `_kernel_packed`), reached through
// encoder_attention(..., pack_pairs=True): q/k/v [B, S, H, D] bf16 with an
// even H, S <= 1024, a key-column mask from valid_len (-1e30 for masked
// keys, so a row with valid_len 0 returns mean(v) over all S keys), fp32
// scores and softmax, bf16 output: the same function as K1
// (encoder_attention.cu), computed for heads 2p and 2p + 1 together.
//
// The Pallas kernel packed a head pair block-diagonally only to fill the
// TPU's 128 MXU lanes with 64-wide heads. On Hopper what a pair offers is
// its layout: in [B, S, H, D], heads 2p and 2p + 1 of a token are one
// contiguous run (256 B at D 64, 288 B at D 72), so one TMA box of
// [2 heads, 64 keys, D] stages a key (or value) tile of both heads.
//
// What bounds it on the H100: the tensor cores and the exponentials. At
// CLIP-L's [64, 577, 16, 64] the two products are 4 * S^2 * D FLOPs a head
// against 4 * S * D * 2 bytes (~290 FLOPs a byte, the ridge); at SigLIP's
// [128, 729, 16, 72] the operations bound it. At D 64 the softmax's one
// exponential a score on the 16-a-clock special-function unit takes as
// long as the two products on the tensor cores, so the two must overlap.
// The design (hopper-kernels §1's shape):
//
// - Warp roles. A block is (128-query tile, head pair, batch row) with
//   three warpgroups. Warpgroup 0 is the producer: it gives its registers
//   up (setmaxnreg, 40 a thread), and its first thread issues TMA loads of
//   both heads' Q tile and then of each key tile's K and V into a ring of
//   kStages stages with mbarrier completion (a stage is released when all 8
//   consumer warps have finished with it). Warpgroups 1 and 2 take the
//   registers (232 a thread) and compute heads 2p and 2p + 1, each over
//   the same 128 query rows as two m64 tiles.
// - Products on wgmma: S = Q K^T with both operands in shared memory, O +=
//   P V with P from registers (the score accumulators are the A fragment)
//   and V as the MN-major operand.
// - Overlap. The two warpgroups ping-pong through two named barriers: one
//   issues its products (S of tile kt and P V of tile kt - 1) while the
//   other runs its softmax. Inside a warpgroup, the maxima and exponents of
//   tile kt are taken while P V of tile kt - 1 runs; the accumulators are
//   rescaled when it has landed (tower_softmax.cuh, K1's softmax: log2
//   domain, FMA-folded exponent, lazy rescale above 2^8, 16- or 32-key
//   products for a narrow tail tile). The turns are peeled so that no
//   wgmma is issued under a branch: ptxas serializes a kernel's wgmma
//   when one is issued in a divergent path (its warning C7520).
// - Layout. Every operand is laid down by TMA in the swizzled layout wgmma
//   reads (hopper_async.cuh): D 64 is one 128-byte-swizzled row. D 72
//   (SigLIP) is wider than the 128-byte swizzle span, so it is split into a
//   64-wide 128-byte-swizzled part and a 16-wide 32-byte-swizzled tail
//   whose lanes 72-79 lie outside the tensor and are zero-filled by TMA:
//   Q K^T takes a fifth k16 step, P V an n16 product beside the n64 one.
// - Edges. TMA zero-fills query and key rows past S; keys past valid_len
//   (and padding past S) are masked in the softmax; tiles wholly past
//   valid_len are not loaded.
//
// The tensor maps are built on the host for each call from the views'
// strides (16-byte multiples, which the wrapper checks), so q/k/v may be
// the strided column slices of the towers' fused qkv projection.

#include <cuda.h>

#include "hopper_async.cuh"
#include "tower_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vl2_hop;
using vl2_tower::kBlockK;

constexpr int kBlockQ = 128;        // query rows a block (two m64 tiles)
constexpr int kThreads = 3 * 128;   // the producer and two consumer groups
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kStages = 3;          // K/V tiles in the ring
constexpr int kTurnBarrier = 1;     // named barriers 1 and 2
// registers a thread after reallocation: 128 x 40 + 256 x 232 <= 65,536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct PairParams {
  CUtensorMap q, k, v;                 // 64-wide boxes, 128-byte swizzle
  CUtensorMap q_tail, k_tail, v_tail;  // D 72: lanes 64-79, 32-byte swizzle
  bf16* o;                             // contiguous [B, S, H, D]
  const int* valid_len;                // [B], or nullptr (= S)
  int S, H, D;
  float scale_log2;                    // softmax scale * log2(e)
};

// Dynamic shared memory, from a 1024-byte-aligned base (bytes): both heads'
// Q tile (the 64-wide part, then the tail), then kStages stages of K and V
// of both heads ([head][row][lane] in each box).
template <int DK>
struct Layout {
  static constexpr bool kTail = DK > 64;
  static constexpr int kQHead = kBlockQ * 128;        // one head's 64 lanes
  static constexpr int kQTailHead = kBlockQ * 32;     // one head's tail
  static constexpr int kKVHead = kBlockK * 128;
  static constexpr int kKVTailHead = kBlockK * 32;
  static constexpr int kQ = 0;
  static constexpr int kQTail = 2 * kQHead;
  static constexpr int kRing = kQTail + (kTail ? 2 * kQTailHead : 0);
  // within a stage: K, V, then (D 72) K's tail and V's tail
  static constexpr int kV = 2 * kKVHead;
  static constexpr int kKTail = 4 * kKVHead;
  static constexpr int kVTail = kKTail + 2 * kKVTailHead;
  static constexpr int kStage = kKTail + (kTail ? 4 * kKVTailHead : 0);
  static constexpr int kBytes = kRing + kStages * kStage;
  static constexpr uint32_t kQTx = kRing;
  static_assert(kQTail % 1024 == 0 && kRing % 1024 == 0 &&
                    kStage % 1024 == 0,
                "swizzled tiles need 1024-byte-aligned bases");
};

struct Barriers {
  uint64_t q_full, full[kStages], empty[kStages];
};

// One consumer warpgroup's state: head h0 + c over rows q0 + [0, 128) as
// two m64 tiles (warp w of the group holds rows 16 w + lane / 4 (+ 8) of
// each), its scores s, the bf16 P fragments pf of the previous tile, the
// output accumulators o and the softmax state.
template <int DK>
struct Consumer {
  using L = Layout<DK>;
  const unsigned char* smem;
  Barriers* bar;
  int c, valid, S;
  float scale_log2;
  uint64_t dq, dq_tail;
  float s[2][8][4];
  uint32_t pf[2][4][4];
  float o[2][DK / 8][4];
  float m_run[2][2], l_run[2][2], alpha[2][2];

  __device__ __forceinline__ const unsigned char* stage(int kt) const {
    return smem + L::kRing + (kt % kStages) * L::kStage;
  }

  __device__ __forceinline__ void fence_all() {
    fence_regs<2 * 8 * 4>(&s[0][0][0]);
    fence_regs<2 * (DK / 8) * 4>(&o[0][0][0]);
    fence_regs<2 * 4 * 4>(&pf[0][0][0]);
  }

  // S = Q K^T of tile kt over kNs * 8 keys, both m64 tiles.
  template <int kNs>
  __device__ __forceinline__ void issue_scores(int kt) {
    const unsigned char* st = stage(kt);
    const uint64_t k = make_desc(st + c * L::kKVHead, 16, 1024, kSwizzle128B);
    const uint64_t k_tail = make_desc(st + L::kKTail + c * L::kKVTailHead, 16,
                                      256, kSwizzle32B);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      auto& d = reinterpret_cast<float(&)[kNs][4]>(s[mt]);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)  // 32 bytes a k16 step inside the row
        wgmma_ss<kNs * 8>(d, dq + mt * (64 * 128 >> 4) + kc * 2, k + kc * 2,
                          kc > 0);
      if constexpr (L::kTail)
        wgmma_ss<kNs * 8>(d, dq_tail + mt * (64 * 32 >> 4), k_tail, 1);
    }
  }

  // O += P V of tile kt over kNs * 8 keys (two 8-key groups a k16 step).
  template <int kNs>
  __device__ __forceinline__ void issue_pv(int kt) {
    const unsigned char* st = stage(kt);
    const uint64_t v = make_desc(st + L::kV + c * L::kKVHead, 8192, 1024,
                                 kSwizzle128B);
    const uint64_t v_tail = make_desc(st + L::kVTail + c * L::kKVTailHead,
                                      2048, 256, kSwizzle32B);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kc = 0; kc < kNs / 2; ++kc) {
        wgmma_rs<64>(reinterpret_cast<float(&)[8][4]>(o[mt][0]), pf[mt][kc],
                     v + kc * (16 * 128 >> 4));
        if constexpr (L::kTail)
          wgmma_rs<16>(reinterpret_cast<float(&)[2][4]>(o[mt][8]),
                       pf[mt][kc], v_tail + kc * (16 * 32 >> 4));
      }
  }

  // This group's turn for tile kt (kNs * 8 keys): S of tile kt and, unless
  // it is the first, P V of tile kt - 1 (a full tile) go to the tensor
  // cores between the turn barriers; the maxima and exponents of tile kt
  // are taken while P V runs; then tile kt - 1's stage is released, o is
  // rescaled where a maximum moved, and P of tile kt is packed.
  template <int kNs, bool kFirst>
  __device__ __forceinline__ void turn(int kt) {
    mbar_wait(&bar->full[kt % kStages], (kt / kStages) & 1);
    named_sync(kTurnBarrier + c, kConsumers);
    fence_all();
    wgmma_fence();
    issue_scores<kNs>(kt);
    wgmma_commit();
    if constexpr (!kFirst) {
      issue_pv<kBlockK / 8>(kt - 1);
      wgmma_commit();
    }
    named_arrive(kTurnBarrier + 1 - c, kConsumers);  // the other group's turn
    wgmma_wait<kFirst ? 0 : 1>();  // S has landed
    fence_regs<2 * 8 * 4>(&s[0][0][0]);
    const int k0 = kt * kBlockK;
    const bool masked = vl2_tower::tile_masked<kNs>(k0, valid);
    float mx[2][2];
    const bool grow = vl2_tower::tile_maxima<2, kNs>(s, mx, m_run, masked, k0,
                                                     valid, S, scale_log2);
    if (grow) vl2_tower::move_maxima<2>(mx, m_run, l_run, alpha);
    vl2_tower::exponentiate<2, kNs>(s, m_run, l_run, masked, scale_log2);
    if constexpr (!kFirst) {
      wgmma_wait<0>();  // P V of tile kt - 1 has landed
      fence_regs<2 * (DK / 8) * 4>(&o[0][0][0]);
      fence_regs<2 * 4 * 4>(&pf[0][0][0]);
      release(kt - 1);
      if (grow) vl2_tower::rescale<2, DK / 8>(o, alpha);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kc = 0; kc < kNs / 2; ++kc)
        vl2_tower::p_fragment(s[mt], kc, pf[mt][kc]);
  }

  // The last turn: P V of the last tile (kNs * 8 keys).
  template <int kNs>
  __device__ __forceinline__ void last_turn(int kt) {
    named_sync(kTurnBarrier + c, kConsumers);
    fence_all();
    wgmma_fence();
    issue_pv<kNs>(kt);
    wgmma_commit();
    if (c == 0) named_arrive(kTurnBarrier + 1, kConsumers);
    wgmma_wait<0>();
    fence_regs<2 * (DK / 8) * 4>(&o[0][0][0]);
  }

  // The consumer warps are done with tile kt's stage.
  __device__ __forceinline__ void release(int kt) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&bar->empty[kt % kStages]);
  }
};

template <int DK>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_attention_pairs_kernel(const __grid_constant__ PairParams p) {
  using L = Layout<DK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ Barriers bar;
  const int q0 = blockIdx.x * kBlockQ, h0 = 2 * blockIdx.y, b = blockIdx.z;
  int valid = p.valid_len ? p.valid_len[b] : p.S;
  valid = valid < 0 ? 0 : (valid > p.S ? p.S : valid);
  const int n_tiles = vl2_tower::key_tiles(p.S, valid);

  if (threadIdx.x == 0) {
    mbar_init(&bar.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer group: one thread issues TMA
    release_registers<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar.q_full, L::kQTx);
      tma_load_4d(smem + L::kQ, &p.q, &bar.q_full, 0, q0, h0, b);
      if constexpr (L::kTail)
        tma_load_4d(smem + L::kQTail, &p.q_tail, &bar.q_full, 64, q0, h0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages, k0 = kt * kBlockK;
        // the stage's previous tile released by all consumer warps
        if (kt >= kStages) mbar_wait(&bar.empty[s], (kt / kStages - 1) & 1);
        unsigned char* st = smem + L::kRing + s * L::kStage;
        mbar_expect_tx(&bar.full[s], L::kStage);
        tma_load_4d(st, &p.k, &bar.full[s], 0, k0, h0, b);
        tma_load_4d(st + L::kV, &p.v, &bar.full[s], 0, k0, h0, b);
        if constexpr (L::kTail) {
          tma_load_4d(st + L::kKTail, &p.k_tail, &bar.full[s], 64, k0, h0, b);
          tma_load_4d(st + L::kVTail, &p.v_tail, &bar.full[s], 64, k0, h0, b);
        }
      }
    }
    return;
  }

  claim_registers<kConsumerRegs>();
  Consumer<DK> g;
  g.smem = smem;
  g.bar = &bar;
  g.c = threadIdx.x / 128 - 1;
  g.valid = valid;
  g.S = p.S;
  g.scale_log2 = p.scale_log2;
  g.dq = make_desc(smem + L::kQ + g.c * L::kQHead, 16, 1024, kSwizzle128B);
  g.dq_tail = make_desc(smem + L::kQTail + g.c * L::kQTailHead, 16, 256,
                        kSwizzle32B);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      g.o[mt][n][0] = g.o[mt][n][1] = g.o[mt][n][2] = g.o[mt][n][3] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      g.m_run[mt][r] = vl2::kMaskedScore;
      g.l_run[mt][r] = 0.f;
      // never read before move_maxima sets it, but without this the D 80
      // instance runs 1.4x slower on the H100 (PERF.md §6)
      g.alpha[mt][r] = 1.f;
    }
  }
  if (g.c == 1) named_arrive(kTurnBarrier, kConsumers);  // group 0 first
  mbar_wait(&bar.q_full, 0);

  // Every tile but the last is a full 64-key tile; the last (ragged edge or
  // valid_len) runs 16-, 32- or 64-key products. Turns alternate between
  // the two groups, group 0 first; no product is issued under a branch
  // inside a turn.
  const int key_end = valid > 0 ? valid : p.S;
  const int last = n_tiles - 1;
  const int last_ns = vl2_tower::score_tiles(key_end - last * kBlockK);
  if (n_tiles > 1) {
    g.template turn<kBlockK / 8, true>(0);
    for (int kt = 1; kt < last; ++kt) g.template turn<kBlockK / 8, false>(kt);
    if (last_ns == 2) {
      g.template turn<2, false>(last);
      g.template last_turn<2>(last);
    } else if (last_ns == 4) {
      g.template turn<4, false>(last);
      g.template last_turn<4>(last);
    } else {
      g.template turn<kBlockK / 8, false>(last);
      g.template last_turn<kBlockK / 8>(last);
    }
  } else if (last_ns == 2) {
    g.template turn<2, true>(0);
    g.template last_turn<2>(0);
  } else if (last_ns == 4) {
    g.template turn<4, true>(0);
    g.template last_turn<4>(0);
  } else {
    g.template turn<kBlockK / 8, true>(0);
    g.template last_turn<kBlockK / 8>(0);
  }

  // out = o / l for this thread's rows; lanes past D and rows past S are
  // not stored.
  const int lane = threadIdx.x % 32, wl = (threadIdx.x / 32) % 4;
  const int t = lane & 3, h = h0 + g.c;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = vl2_tower::inverse_row_sum(g.l_run[mt][r]);
      const int row = q0 + mt * 64 + wl * 16 + (lane >> 2) + r * 8;
      if (row >= p.S) continue;
      bf16* out = p.o + ((long long)(b * p.S + row) * p.H + h) * p.D;
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        const int d = n * 8 + 2 * t;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
              g.o[mt][n][2 * r] * inv, g.o[mt][n][2 * r + 1] * inv);
      }
    }
}

template <int DK>
cudaError_t launch(const PairParams& p, int B, cudaStream_t st) {
  constexpr int kSmem = Layout<DK>::kBytes + 1024;  // + the base alignment
  auto kernel = encoder_attention_pairs_kernel<DK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H / 2, B);
  kernel<<<grid, kThreads, kSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers; strides are in elements, and every stride and base is a
// multiple of 16 bytes (the wrapper checks it: TMA takes nothing else); the
// last axis of q/k/v is contiguous; H is even. A view TMA refuses returns
// cudaErrorInvalidValue before any launch.
extern "C" int vl2_encoder_attention_pairs(
    const void* q, const void* k, const void* v, void* o,
    const int* valid_len, int B, int S, int H, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  if (H % 2 || (D != 64 && D != 72))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  PairParams p;
  const bool tail = D > 64;
  const struct {
    CUtensorMap* main;
    CUtensorMap* tail;
    const void* base;
    long long sb, ss, sh;
    int rows;
  } views[3] = {{&p.q, &p.q_tail, q, q_sb, q_ss, q_sh, kBlockQ},
                {&p.k, &p.k_tail, k, k_sb, k_ss, k_sh, kBlockK},
                {&p.v, &p.v_tail, v, v_sb, v_ss, v_sh, kBlockK}};
  for (const auto& t : views) {
    if (!make_map(t.main, t.base, B, S, H, D, t.sb, t.ss, t.sh, 64, t.rows,
                  2, CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
    // the tail's map is never read at D 64: a copy of the main one
    if (!tail)
      *t.tail = *t.main;
    else if (!make_map(t.tail, t.base, B, S, H, D, t.sb, t.ss, t.sh, 16,
                       t.rows, 2, CU_TENSOR_MAP_SWIZZLE_32B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.o = static_cast<bf16*>(o);
  p.valid_len = valid_len;
  p.S = S; p.H = H; p.D = D;
  p.scale_log2 = scale * vl2_tower::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 64 ? launch<64>(p, B, st)
                                  : launch<80>(p, B, st));
}
