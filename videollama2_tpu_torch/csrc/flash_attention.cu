// K2: causal GQA flash attention, forward, for the LLM prefill and the
// training forward.
//
// Replaces videollama2_tpu/ops/flash_attention.py::flash_attention (Pallas
// `_flash_kernel`, with its optional LSE output): q [B, Sq, Hq, D],
// k/v [B, Sk, Hkv, D] bf16 read through their strides (views of the fused
// qkv projection), query head h reads kv head h / (Hq / Hkv), keys at or
// past valid_len[b] and (causal, top-left aligned) above the diagonal are
// masked with -1e30, the softmax state stays fp32, o is contiguous
// [B, Sq, Hq, D] bf16, and a row with valid_len == 0 returns mean(v) over
// all Sk keys. With a non-null `lse` the kernel also stores each row's
// natural-log log-sum-exp as fp32 [B, Hq, Sq] (the residual of the training
// backward: K8 in flash_attention_bwd.cu, K9 in flash_attention_dkv.cu; the
// Pallas kernel's 128-lane broadcast of it was a TPU layout rule and is not
// kept); a fully masked row's lse is exactly -1e30. The serving path passes
// null and does no extra work.
//
// What bounds it on the H100: at the Mistral prefill (q [4, 1664, 32, 128]
// on 8 kv heads) and the training shape (q [8, 2048, 32, 128]) the two
// products are 4 * D FLOPs a visible (query, key) pair against ~4 * S * D
// bytes a head: far above the ridge, it is tensor-core bound, with one
// exponential a score on the special-function unit beside the products.
// The design is K10's (encoder_attention_pairs.cu), made causal, grouped
// and with the LSE:
//
// - Warp roles. A block is (128-query tile, query head, batch row) with
//   three warpgroups. Warpgroup 0 is the producer: it gives its registers
//   up (setmaxnreg, 24 a thread), and its first thread issues the TMA load
//   of the Q tile once and then each 128-key tile's K and V into a ring of
//   kStages stages with mbarrier completion (a stage is released when all 8
//   consumer warps are done with it). Warpgroups 1 and 2 take the
//   registers (240 a thread) and each computes one m64 half of the query
//   rows against the same K/V stages.
// - Products on wgmma: S = Q K^T (m64 n128, both operands in shared
//   memory), O += P V with P from registers (the score accumulators are the
//   A fragment) and V as the MN-major operand.
// - Overlap. The two consumer warpgroups ping-pong through two named
//   barriers: one issues its products (S of tile kt and P V of tile
//   kt - 1) while the other runs its softmax; inside a warpgroup the maxima
//   and exponents of tile kt are taken while P V of tile kt - 1 runs
//   (tower_softmax.cuh's log2-domain softmax with lazy rescale).
// - Masks only where needed. Every tile but a block's last lies wholly
//   below the diagonal and inside valid_len and Sk, and takes no mask: the
//   last (the diagonal tile, or the valid_len or Sk edge) is scaled and
//   masked element by element, as is every tile when valid_len is 0. The
//   flag changes only the softmax: no wgmma is issued under a branch
//   (ptxas would serialize them, its warning C7520).
// - Layout. D 128 is two 64-wide boxes of the 128-byte swizzle (Q K^T
//   steps from the first box into the second; P V's N axis spans both, the
//   descriptor's LBO being the box size); TMA zero-fills rows past Sq and
//   Sk. Blocks run heaviest first: the causal grid walks the query tiles
//   from the last, over every head and batch row of a tile before the next.

#include <cuda.h>

#include "hopper_async.cuh"
#include "tower_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vl2_hop;

constexpr int kBlockQ = 128;        // query rows a block (two m64 tiles)
constexpr int kBlockK = 128;        // keys a tile
constexpr int kNs = kBlockK / 8;    // n8 score tiles of a key tile
constexpr int kThreads = 3 * 128;   // the producer and two consumer groups
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kStages = 3;          // K/V tiles in the ring
constexpr int kTurnBarrier = 1;     // named barriers 1 and 2
// registers a thread after reallocation: 128 x 24 + 256 x 240 = 64,512, the
// 168 x 384 the block is launched with (a warpgroup that asks for more than
// the others gave up waits in setmaxnreg for ever)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLn2 = 0.6931471805599453f;

struct FlashParams {
  CUtensorMap q, k, v;   // boxes of 64 lanes x 128 rows, 128-byte swizzle
  bf16* o;               // contiguous [B, Sq, Hq, D]
  float* lse;            // [B, Hq, Sq], or nullptr
  const int* valid_len;  // [B], or nullptr (= Sk)
  int Sq, Sk, Hq, Hkv;
  float scale_log2;      // softmax scale * log2(e)
};

// Dynamic shared memory, from a 1024-byte-aligned base (bytes): the Q tile
// (DK / 64 boxes of [128 rows][64 lanes]), then kStages stages of K and V
// (DK / 64 boxes of [128 keys][64 lanes] each).
template <int DK>
struct Layout {
  static constexpr int kBoxes = DK / 64;
  static constexpr int kQBox = kBlockQ * 128;
  static constexpr int kKVBox = kBlockK * 128;
  static constexpr int kRing = kBoxes * kQBox;
  static constexpr int kV = kBoxes * kKVBox;  // within a stage
  static constexpr int kStage = 2 * kBoxes * kKVBox;
  static constexpr int kBytes = kRing + kStages * kStage;
  static_assert(kRing % 1024 == 0 && kStage % 1024 == 0,
                "swizzled tiles need 1024-byte-aligned bases");
};

struct Barriers {
  uint64_t q_full, full[kStages], empty[kStages];
};

// The number of key tiles a block visits: those holding a key some row of
// the block sees. Tiles wholly past valid_len or (causal) above the
// diagonal would add exp2(-1e30 - m) == 0 to every row and are skipped;
// with valid_len == 0 every key is masked and all Sk keys are visited, so
// the rows return mean(v).
template <bool kCausal>
__device__ __forceinline__ int key_tiles(int Sk, int valid, int q0) {
  int n = (Sk + kBlockK - 1) / kBlockK;
  if (valid > 0) {
    n = min(n, (valid + kBlockK - 1) / kBlockK);
    if (kCausal) n = min(n, (q0 + kBlockQ - 1) / kBlockK + 1);
  }
  return n;
}

// Each row's maximum over a score tile s (log2 domain, quad-reduced into
// mx); with `masked`, s is scaled and masked in place first: a key at or
// past valid_len or (causal) above the row's diagonal gets -1e30, padding
// past Sk -inf. Returns, for the whole warp, whether some row's maximum
// rose more than kRescaleSlack above m_run.
template <bool kCausal>
__device__ __forceinline__ bool tile_maxima(float (&s)[1][kNs][4],
                                            float (&mx)[1][2],
                                            const float (&m_run)[1][2],
                                            bool masked, int k0, int row0,
                                            int valid, int Sk,
                                            float scale_log2) {
  const int t = (threadIdx.x % 32) & 3;
  mx[0][0] = mx[0][1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kNs; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[0][n][e];
      if (masked) {
        x *= scale_log2;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool keep = col < valid && (!kCausal || col <= row);
        if (!keep) x = col < Sk ? vl2::kMaskedScore : -INFINITY;
        s[0][n][e] = x;
      }
      mx[0][e >> 1] = fmaxf(mx[0][e >> 1], x);
    }
  bool grow = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = masked ? mx[0][r] : mx[0][r] * scale_log2;
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    mx[0][r] = m;
    grow |= m > m_run[0][r] + vl2_tower::kRescaleSlack;
  }
  return __any_sync(0xffffffffu, grow);
}

// One consumer warpgroup's state: query rows q0 + 64 c + [0, 64) of one
// head (warp w of the group holds rows 16 w + lane / 4 (+ 8)), its scores
// s, the bf16 P fragments pf of the previous tile, the output accumulators
// o and the softmax state.
template <int DK, bool kCausal>
struct Consumer {
  using L = Layout<DK>;
  const unsigned char* smem;
  Barriers* bar;
  int c, row0, valid, Sk;
  float scale_log2;
  uint64_t dq;
  float s[1][kNs][4];
  uint32_t pf[kBlockK / 16][4];
  float o[1][DK / 8][4];
  float m_run[1][2], l_run[1][2], alpha[1][2];

  __device__ __forceinline__ const unsigned char* stage(int kt) const {
    return smem + L::kRing + (kt % kStages) * L::kStage;
  }

  __device__ __forceinline__ void fence_all() {
    fence_regs<kNs * 4>(&s[0][0][0]);
    fence_regs<(DK / 8) * 4>(&o[0][0][0]);
    fence_regs<(kBlockK / 16) * 4>(&pf[0][0]);
  }

  // S = Q K^T of tile kt: DK / 16 k16 steps, 32 bytes apart inside a
  // 128-byte row, the fifth step in the second box.
  __device__ __forceinline__ void issue_scores(int kt) {
    const uint64_t k = make_desc(stage(kt), 16, 1024, kSwizzle128B);
#pragma unroll
    for (int kc = 0; kc < DK / 16; ++kc) {
      const int at = (kc / 4) * L::kQBox + (kc % 4) * 32;
      const int bt = (kc / 4) * L::kKVBox + (kc % 4) * 32;
      wgmma_ss<kBlockK>(s[0], dq + (at >> 4), k + (bt >> 4), kc > 0);
    }
  }

  // O += P V of tile kt: kBlockK / 16 k16 steps of 16 keys (two 8-row
  // groups); N = DK spans the boxes (LBO = the box size).
  __device__ __forceinline__ void issue_pv(int kt) {
    const uint64_t v = make_desc(stage(kt) + L::kV, L::kKVBox, 1024,
                                 kSwizzle128B);
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc)
      wgmma_rs<DK>(o[0], pf[kc], v + kc * (16 * 128 >> 4));
  }

  // This group's turn for tile kt: S of tile kt and, unless it is the
  // first, P V of tile kt - 1 go to the tensor cores between the turn
  // barriers; the maxima and exponents of tile kt are taken while P V
  // runs; then tile kt - 1's stage is released, o is rescaled where a
  // maximum moved, and P of tile kt is packed.
  template <bool kFirst>
  __device__ __forceinline__ void turn(int kt, bool masked) {
    mbar_wait(&bar->full[kt % kStages], (kt / kStages) & 1);
    named_sync(kTurnBarrier + c, kConsumers);
    fence_all();
    wgmma_fence();
    issue_scores(kt);
    wgmma_commit();
    if constexpr (!kFirst) {
      issue_pv(kt - 1);
      wgmma_commit();
    }
    named_arrive(kTurnBarrier + 1 - c, kConsumers);  // the other group's turn
    wgmma_wait<kFirst ? 0 : 1>();  // S has landed
    fence_regs<kNs * 4>(&s[0][0][0]);
    float mx[1][2];
    const bool grow = tile_maxima<kCausal>(s, mx, m_run, masked, kt * kBlockK,
                                           row0, valid, Sk, scale_log2);
    if (grow) vl2_tower::move_maxima<1>(mx, m_run, l_run, alpha);
    vl2_tower::exponentiate<1, kNs>(s, m_run, l_run, masked, scale_log2);
    if constexpr (!kFirst) {
      wgmma_wait<0>();  // P V of tile kt - 1 has landed
      fence_regs<(DK / 8) * 4>(&o[0][0][0]);
      fence_regs<(kBlockK / 16) * 4>(&pf[0][0]);
      release(kt - 1);
      if (grow) vl2_tower::rescale<1, DK / 8>(o, alpha);
    }
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc)
      vl2_tower::p_fragment(s[0], kc, pf[kc]);
  }

  // The last turn: P V of the last tile.
  __device__ __forceinline__ void last_turn(int kt) {
    named_sync(kTurnBarrier + c, kConsumers);
    fence_all();
    wgmma_fence();
    issue_pv(kt);
    wgmma_commit();
    if (c == 0) named_arrive(kTurnBarrier + 1, kConsumers);
    wgmma_wait<0>();
    fence_regs<(DK / 8) * 4>(&o[0][0][0]);
    fence_regs<(kBlockK / 16) * 4>(&pf[0][0]);
  }

  // The consumer warps are done with tile kt's stage.
  __device__ __forceinline__ void release(int kt) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&bar->empty[kt % kStages]);
  }
};

template <int DK, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ FlashParams p) {
  using L = Layout<DK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ Barriers bar;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qtile = kCausal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qtile * kBlockQ;
  const int kvh = h / (p.Hq / p.Hkv);  // GQA: query head h reads kv h / G
  int valid = p.valid_len ? p.valid_len[b] : p.Sk;
  valid = valid < 0 ? 0 : (valid > p.Sk ? p.Sk : valid);
  const int n_tiles = key_tiles<kCausal>(p.Sk, valid, q0);

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
      mbar_expect_tx(&bar.q_full, L::kRing);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load_4d(smem + x * L::kQBox, &p.q, &bar.q_full, 64 * x, q0, h,
                    b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages, k0 = kt * kBlockK;
        // the stage's previous tile released by all consumer warps
        if (kt >= kStages) mbar_wait(&bar.empty[s], (kt / kStages - 1) & 1);
        unsigned char* st = smem + L::kRing + s * L::kStage;
        mbar_expect_tx(&bar.full[s], L::kStage);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load_4d(st + x * L::kKVBox, &p.k, &bar.full[s], 64 * x, k0,
                      kvh, b);
          tma_load_4d(st + L::kV + x * L::kKVBox, &p.v, &bar.full[s], 64 * x,
                      k0, kvh, b);
        }
      }
    }
    return;
  }

  claim_registers<kConsumerRegs>();
  const int lane = threadIdx.x % 32, wl = (threadIdx.x / 32) % 4;
  Consumer<DK, kCausal> g;
  g.smem = smem;
  g.bar = &bar;
  g.c = threadIdx.x / 128 - 1;
  g.row0 = q0 + g.c * 64 + wl * 16 + (lane >> 2);
  g.valid = valid;
  g.Sk = p.Sk;
  g.scale_log2 = p.scale_log2;
  g.dq = make_desc(smem + g.c * 64 * 128, 16, 1024, kSwizzle128B);
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
    g.o[0][n][0] = g.o[0][n][1] = g.o[0][n][2] = g.o[0][n][3] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    g.m_run[0][r] = vl2::kMaskedScore;
    g.l_run[0][r] = 0.f;
    g.alpha[0][r] = 1.f;
  }
  if (g.c == 1) named_arrive(kTurnBarrier, kConsumers);  // group 0 first
  mbar_wait(&bar.q_full, 0);

  // Turns alternate between the two groups, group 0 first. Only the last
  // tile (all of them with valid_len 0) is masked.
  const int last = n_tiles - 1;
  const bool all_masked = valid == 0;
  if (n_tiles > 1) {
    g.template turn<true>(0, all_masked);
    for (int kt = 1; kt < last; ++kt) g.template turn<false>(kt, all_masked);
    g.template turn<false>(last, true);
  } else {
    g.template turn<true>(0, true);
  }
  g.last_turn(last);

  // out = o / l for this thread's rows (rows past Sq are not stored); with
  // an lse pointer, lane t == 0 of each quad stores the row's log-sum-exp,
  // m ln 2 + ln l (a row that saw only masked keys keeps m = -1e30: its lse
  // is exactly -1e30).
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g.row0 + r * 8;
    float l = g.l_run[0][r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = l == 0.f ? 1.f : l;
    if (row >= p.Sq) continue;
    if (p.lse != nullptr && t == 0) {
      const float m = g.m_run[0][r];
      p.lse[((long long)b * p.Hq + h) * p.Sq + row] =
          m == vl2::kMaskedScore ? vl2::kMaskedScore : m * kLn2 + logf(l);
    }
    const float inv = 1.f / l;
    bf16* out = p.o + ((long long)(b * p.Sq + row) * p.Hq + h) * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(g.o[0][n][2 * r] * inv,
                                g.o[0][n][2 * r + 1] * inv);
  }
}

// Sets the kernel's shared memory once and launches it over (query head,
// batch row, query tile).
template <int DK, bool kCausal>
cudaError_t launch(const FlashParams& p, int B, cudaStream_t st) {
  constexpr int kSmem = Layout<DK>::kBytes + 1024;  // + the base alignment
  auto kernel = flash_attention_kernel<DK, kCausal>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(p.Hq, B, (p.Sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, kSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers; strides are in elements, every stride and base a multiple of 16
// bytes (the wrapper checks it: TMA takes nothing else); the last axis of
// q/k/v is contiguous. D 64 or 128 and Hq % Hkv == 0; anything else, or a
// view TMA refuses, returns cudaErrorInvalidValue before any launch.
extern "C" int vl2_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* valid_len, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, void* stream) {
  if ((D != 64 && D != 128) || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  if (!make_map(&p.q, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, 64, kBlockQ, 1,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.k, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, 64, kBlockK, 1,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.v, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, 64, kBlockK, 1,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.valid_len = valid_len;
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv;
  p.scale_log2 = scale * vl2_tower::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (D == 128)
    return static_cast<int>(c ? launch<128, true>(p, B, st)
                              : launch<128, false>(p, B, st));
  return static_cast<int>(c ? launch<64, true>(p, B, st)
                            : launch<64, false>(p, B, st));
}
