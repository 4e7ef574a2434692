// K8: the backward of causal GQA flash attention, dq, for training.
//
// Replaces the dq Pallas kernel of
// videollama2_tpu/ops/flash_attention.py::flash_attention_bwd
// (`_flash_bwd_dq_kernel`): dq from q, k, v, o, do, lse and valid_len.
// Layouts: q [B, Sq, Hq, D] and k/v [B, Sk, Hkv, D] bf16 read through their
// strides (views of the fused qkv projection need no copy); o and do
// contiguous [B, Sq, Hq, D] bf16; lse fp32 [B, Hq, Sq] from the forward
// (K2, flash_attention.cu); output dq [B, Sq, Hq, D] contiguous bf16. The
// FlashAttention-2 formulas, with fp32 scores and sums and bf16 operands to
// every product:
//   delta_i = rowsum(do_i * o_i)
//   p_ij    = mask_ij ? exp(q_i k_j^T * scale - lse_i) : 0
//   ds_ij   = p_ij * (do_i v_j^T - delta_i) * scale
//   dq_i    = sum_j ds_ij k_j
// The mask is explicit (key < valid_len, and key <= query when causal): a
// fully masked row carries lse = -1e30, where exp(s - lse) would overflow,
// so a masked p is set to zero, not exponentiated, and such a row's dq is
// exactly zero, as in the Pallas kernel.
//
// Delta: K8 computes delta once per query row, from o and do, and stores
// it as fp32 [B, Hq, Sq]; K9 (flash_attention_dkv.cu, launched after K8 on
// the same stream) reads it instead of recomputing it for every key tile.
// There is no separate delta pass.
//
// What bounds it on the H100: at the training shape (q [8, 2048, 32, 128],
// k/v [8, 2048, 8, 128], causal) its three products are 6 * D FLOPs a
// visible (query, key) pair (4.0e11 FLOPs) against ~0.3 GB: tensor-core
// bound. The design is K9's, turned around the query rows, with K2's
// ping-pong:
//
// - Blocks. A block owns 128 query rows of one query head and batch row, as
//   two m64 tiles, one a consumer warpgroup; their Q and dO tiles stay
//   resident in shared memory. It walks the 64-key tiles of its kv head
//   (h / (Hq / Hkv)) from the first to the last one that holds a key some
//   row of the block sees (the diagonal, valid_len). No atomics: every dq
//   row is written by one block, and the result is the same from call to
//   call. Causal grids run the query tiles from the last (the heaviest:
//   they see the most keys), over every head and batch row of a tile before
//   the next.
// - Warp roles. Warpgroup 0 is the producer (setmaxnreg 40): its first
//   thread TMA-loads Q and dO once and each key tile's K and V into a ring
//   of kStages stages with mbarrier completion (a stage is released when
//   all 8 consumer warps are done with it). Warpgroups 1 and 2 (232
//   registers) compute.
// - Prologue. A consumer thread's two rows are fixed by the wgmma
//   accumulator layout, so it keeps their lse x log2 e and delta in
//   registers for the whole loop. It computes delta from o and do in device
//   memory (a quad splits the head dim) while the first tiles load, and its
//   quad's first thread stores it.
// - Products on wgmma, a key tile: S = Q K^T and dP = dO V^T (m64 n64, both
//   operands in shared memory), then P = exp2(S scale log2 e - lse log2 e)
//   under the mask and dS = P (dP - delta) scale in registers, then
//   dQ += dS K with dS from registers (packed bf16, the A operand) and K as
//   the MN-major B operand (N = D spans the two 64-wide boxes at D 128).
//   dQ (64 fp32 a thread at D 128) stays in registers and is stored once,
//   as bf16.
// - Overlap. The two consumer warpgroups ping-pong through two named
//   barriers, as K2's do: one issues its products (S and dP of tile kt, dQ
//   of tile kt - 1) while the other runs its elementwise pass; inside a
//   warpgroup P of tile kt is taken while dP of tile kt and dQ of tile
//   kt - 1 run.
// - Masks only where needed: a tile that reaches past valid_len (only a
//   block's last can) or, causal, past the diagonal of the warpgroup's
//   first row (a block's last tile, and for the first warpgroup the one
//   before it) is masked element by element; every other tile is not. The
//   first and last turns are peeled and the flag changes only the
//   elementwise pass, so no wgmma is issued under a branch (ptxas would
//   serialize them, its warning C7520). With valid_len 0 every p is 0: the
//   block visits no tile and stores zeros.

#include <cuda.h>

#include "hopper_async.cuh"
#include "tower_softmax.cuh"  // ex2, kLog2e, p_fragment

namespace {

using bf16 = __nv_bfloat16;
using namespace vl2_hop;

constexpr int kBlockQ = 128;       // query rows a block (two m64 tiles)
constexpr int kBlockK = 64;        // keys a tile
constexpr int kNs = kBlockK / 8;   // n8 score tiles of a key tile
constexpr int kThreads = 3 * 128;  // the producer and two consumer groups
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kStages = 4;         // K/V tiles in the ring
constexpr int kTurnBarrier = 1;    // named barriers 1 and 2
// registers a thread after reallocation, within the 168 x 384 = 64,512 the
// block is launched with (128 x 40 + 256 x 232): a warpgroup that asks for
// more than the others gave up waits in setmaxnreg for ever
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct DqParams {
  CUtensorMap q, dout;   // boxes of 64 lanes x 128 rows, 128-byte swizzle
  CUtensorMap k, v;      // boxes of 64 lanes x 64 rows
  const bf16* o;         // contiguous [B, Sq, Hq, D]
  const bf16* dout_rows; // contiguous [B, Sq, Hq, D]: do, for delta
  const float* lse;      // [B, Hq, Sq]
  float* delta;          // [B, Hq, Sq]: written here, read by K9
  bf16* dq;              // contiguous [B, Sq, Hq, D]
  const int* valid_len;  // [B], or nullptr (= Sk)
  int Sq, Sk, Hq, Hkv;
  float scale, scale_log2;
};

// Dynamic shared memory, from a 1024-byte-aligned base (bytes): Q and dO
// (DK / 64 boxes of [128 rows][64 lanes] each), then kStages stages of K
// and V (DK / 64 boxes of [64 keys][64 lanes] each).
template <int DK>
struct Layout {
  static constexpr int kBoxes = DK / 64;
  static constexpr int kQBox = kBlockQ * 128;
  static constexpr int kKVBox = kBlockK * 128;
  static constexpr int kDO = kBoxes * kQBox;
  static constexpr int kRing = 2 * kBoxes * kQBox;
  static constexpr int kV = kBoxes * kKVBox;  // within a stage
  static constexpr int kStage = 2 * kBoxes * kKVBox;
  static constexpr int kBytes = kRing + kStages * kStage;
  static_assert(kDO % 1024 == 0 && kRing % 1024 == 0 && kV % 1024 == 0 &&
                    kStage % 1024 == 0,
                "swizzled tiles need 1024-byte-aligned bases");
};

struct Barriers {
  uint64_t qdo_full, full[kStages], empty[kStages];
};

// The number of key tiles a block visits: those holding a key below
// valid_len that (causal) some row of the block sees. valid is clamped to
// [0, Sk]; valid 0 visits none.
template <bool kCausal>
__device__ __forceinline__ int key_tiles(int valid, int Sq, int q0) {
  int n = (valid + kBlockK - 1) / kBlockK;
  if (kCausal) n = min(n, (min(q0 + kBlockQ, Sq) - 1) / kBlockK + 1);
  return n;
}

// One consumer warpgroup's state: query rows q0 + 64 c + [0, 64) of one
// head (warp w of the group holds rows 16 w + lane / 4 (+ 8)), the score
// and dP accumulators of the current tile, the bf16 dS fragments of the
// previous one, and the dQ accumulators.
template <int DK, bool kCausal>
struct Consumer {
  using L = Layout<DK>;
  const unsigned char* smem;
  Barriers* bar;
  int c, row0, first_row, valid;
  float scale, scale_log2;
  uint64_t qa, da;  // this group's Q and dO rows, the A operands
  float lse2[2], delta[2];
  float s[kNs][4], dp[kNs][4];
  uint32_t sf[kBlockK / 16][4];
  float dq[DK / 8][4];

  __device__ __forceinline__ const unsigned char* stage(int kt) const {
    return smem + L::kRing + (kt % kStages) * L::kStage;
  }

  __device__ __forceinline__ void fence_all() {
    fence_regs<kNs * 4>(&s[0][0]);
    fence_regs<kNs * 4>(&dp[0][0]);
    fence_regs<(DK / 8) * 4>(&dq[0][0]);
    fence_regs<(kBlockK / 16) * 4>(&sf[0][0]);
  }

  // Whether tile kt is masked element by element: it reaches past
  // valid_len or (causal) past the diagonal of the group's first row.
  __device__ __forceinline__ bool masked(int kt) const {
    const int k_last = kt * kBlockK + kBlockK - 1;
    return k_last >= valid || (kCausal && k_last > first_row);
  }

  // S = Q K^T and dP = dO V^T of tile kt, one commit group each: DK / 16
  // k16 steps, 32 bytes apart inside a 128-byte row, the fifth step in the
  // second box.
  __device__ __forceinline__ void issue_scores(int kt) {
    const uint64_t k = make_desc(stage(kt), 16, 1024, kSwizzle128B);
    const uint64_t v = make_desc(stage(kt) + L::kV, 16, 1024, kSwizzle128B);
#pragma unroll
    for (int kc = 0; kc < DK / 16; ++kc) {
      const int at = (kc / 4) * L::kQBox + (kc % 4) * 32;
      const int bt = (kc / 4) * L::kKVBox + (kc % 4) * 32;
      wgmma_ss<kBlockK>(s, qa + (at >> 4), k + (bt >> 4), kc > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < DK / 16; ++kc) {
      const int at = (kc / 4) * L::kQBox + (kc % 4) * 32;
      const int bt = (kc / 4) * L::kKVBox + (kc % 4) * 32;
      wgmma_ss<kBlockK>(dp, da + (at >> 4), v + (bt >> 4), kc > 0);
    }
    wgmma_commit();
  }

  // dQ += dS K of tile kt: kBlockK / 16 k16 steps of 16 keys (two 8-row
  // groups); N = DK spans the boxes (LBO = the box size).
  __device__ __forceinline__ void issue_dq(int kt) {
    const uint64_t k = make_desc(stage(kt), L::kKVBox, 1024, kSwizzle128B);
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc)
      wgmma_rs<DK>(dq, sf[kc], k + kc * (16 * 128 >> 4));
  }

  // P of tile kt in s: exp2(S scale log2 e - lse log2 e), and with
  // `is_masked` zero where the key is at or past valid_len or (causal)
  // above the row's diagonal.
  __device__ __forceinline__ void probabilities(int kt, bool is_masked) {
    const int t = (threadIdx.x % 32) & 3;
    const int k0 = kt * kBlockK;
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = vl2_tower::ex2(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
        if (is_masked) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int query = row0 + (e >> 1) * 8;
          const bool keep = key < valid && (!kCausal || key <= query);
          pe = keep ? pe : 0.f;
        }
        s[n][e] = pe;
      }
  }

  // This group's turn for tile kt: S and dP of tile kt and, unless it is
  // the first, dQ of tile kt - 1 go to the tensor cores between the turn
  // barriers; P is taken while dP runs, dS (in dp) once dP has landed;
  // then tile kt - 1's stage is released and dS of tile kt is packed.
  template <bool kFirst>
  __device__ __forceinline__ void turn(int kt, bool is_masked) {
    mbar_wait(&bar->full[kt % kStages], (kt / kStages) & 1);
    named_sync(kTurnBarrier + c, kConsumers);
    fence_all();
    wgmma_fence();
    issue_scores(kt);
    if constexpr (!kFirst) {
      issue_dq(kt - 1);
      wgmma_commit();
    }
    named_arrive(kTurnBarrier + 1 - c, kConsumers);  // the other group's turn
    wgmma_wait<kFirst ? 1 : 2>();  // S has landed
    fence_regs<kNs * 4>(&s[0][0]);
    probabilities(kt, is_masked);
    wgmma_wait<kFirst ? 0 : 1>();  // dP has landed
    fence_regs<kNs * 4>(&dp[0][0]);
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - delta[e >> 1]) * scale;  // dS
    if constexpr (!kFirst) {
      wgmma_wait<0>();  // dQ of tile kt - 1 has landed
      fence_regs<(DK / 8) * 4>(&dq[0][0]);
      fence_regs<(kBlockK / 16) * 4>(&sf[0][0]);
      release(kt - 1);
    }
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc)
      vl2_tower::p_fragment(dp, kc, sf[kc]);
  }

  // The last turn: dQ of the last tile.
  __device__ __forceinline__ void last_turn(int kt) {
    named_sync(kTurnBarrier + c, kConsumers);
    fence_all();
    wgmma_fence();
    issue_dq(kt);
    wgmma_commit();
    if (c == 0) named_arrive(kTurnBarrier + 1, kConsumers);
    wgmma_wait<0>();
    fence_regs<(DK / 8) * 4>(&dq[0][0]);
    fence_regs<(kBlockK / 16) * 4>(&sf[0][0]);
  }

  // The consumer warps are done with tile kt's stage.
  __device__ __forceinline__ void release(int kt) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&bar->empty[kt % kStages]);
  }
};

template <int DK, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqParams p) {
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
  const int n_tiles = key_tiles<kCausal>(valid, p.Sq, q0);

  if (threadIdx.x == 0) {
    mbar_init(&bar.qdo_full, 1);
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
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(&bar.qdo_full, L::kRing);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load_4d(smem + x * L::kQBox, &p.q, &bar.qdo_full, 64 * x, q0, h,
                    b);
        tma_load_4d(smem + L::kDO + x * L::kQBox, &p.dout, &bar.qdo_full,
                    64 * x, q0, h, b);
      }
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
  const int t = lane & 3;
  Consumer<DK, kCausal> g;
  g.smem = smem;
  g.bar = &bar;
  g.c = threadIdx.x / 128 - 1;
  g.first_row = q0 + g.c * 64;
  g.row0 = g.first_row + wl * 16 + (lane >> 2);
  g.valid = valid;
  g.scale = p.scale;
  g.scale_log2 = p.scale_log2;
  g.qa = make_desc(smem + g.c * 64 * 128, 16, 1024, kSwizzle128B);
  g.da = make_desc(smem + L::kDO + g.c * 64 * 128, 16, 1024, kSwizzle128B);

  // delta and lse x log2 e of this thread's rows row0 and row0 + 8 (the
  // quad splits the head dim in 16-byte chunks); rows past Sq get delta 0
  // and lse +inf, so their p is 0.
  const long long o_row = (long long)p.Hq * DK;  // o/do/dq row stride
  const long long rows = ((long long)b * p.Hq + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g.row0 + r * 8;
    float sum = 0.f;
    if (row < p.Sq) {
      const long long off = ((long long)b * p.Sq + row) * o_row + h * DK;
#pragma unroll
      for (int x = t * 8; x < DK; x += 32) {
        const uint4 ov = *reinterpret_cast<const uint4*>(p.o + off + x);
        const uint4 dv =
            *reinterpret_cast<const uint4*>(p.dout_rows + off + x);
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          sum += of.x * df.x + of.y * df.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    g.delta[r] = sum;
    g.lse2[r] =
        row < p.Sq ? p.lse[rows + row] * vl2_tower::kLog2e : INFINITY;
    if (t == 0 && row < p.Sq) p.delta[rows + row] = sum;
  }
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
    g.dq[n][0] = g.dq[n][1] = g.dq[n][2] = g.dq[n][3] = 0.f;

  // Turns alternate between the two groups, group 0 first; only the
  // tiles at the valid_len edge and the diagonal are masked.
  if (n_tiles > 0) {
    if (g.c == 1) named_arrive(kTurnBarrier, kConsumers);  // group 0 first
    mbar_wait(&bar.qdo_full, 0);
    g.template turn<true>(0, g.masked(0));
    for (int kt = 1; kt < n_tiles; ++kt)
      g.template turn<false>(kt, g.masked(kt));
    g.last_turn(n_tiles - 1);
  }

  // this thread's rows row0 and row0 + 8 (rows past Sq are not stored;
  // zeros when no tile was visited)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g.row0 + r * 8;
    if (row >= p.Sq) continue;
    bf16* out = p.dq + ((long long)b * p.Sq + row) * o_row + h * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(g.dq[n][2 * r], g.dq[n][2 * r + 1]);
  }
}

// Sets the kernel's shared memory once and launches it over (query head,
// batch row, query tile).
template <int DK, bool kCausal>
cudaError_t launch(const DqParams& p, int B, cudaStream_t st) {
  constexpr int kSmem = Layout<DK>::kBytes + 1024;  // + the base alignment
  auto kernel = flash_bwd_dq_kernel<DK, kCausal>;
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

// K8: dq and delta. Returns the cudaError_t of the launch (0 on success).
// Pointers are device pointers; strides are in elements, every stride and
// base a multiple of 16 bytes (TMA takes nothing else); the last axis of
// q/k/v is contiguous; o/do contiguous [B, Sq, Hq, D]; lse/delta
// [B, Hq, Sq]. D 64 or 128 and Hq % Hkv == 0; anything else, or a view TMA
// refuses, returns cudaErrorInvalidValue before any launch.
extern "C" int vl2_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq,
    const int* valid_len, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, void* stream) {
  if ((D != 64 && D != 128) || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  DqParams p;
  const long long o_ss = (long long)Hq * D;
  if (!make_map(&p.q, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, 64, kBlockQ, 1,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.dout, dout, B, Sq, Hq, D, Sq * o_ss, o_ss, D, 64, kBlockQ,
                1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.k, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, 64, kBlockK, 1,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.v, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, 64, kBlockK, 1,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<const bf16*>(o);
  p.dout_rows = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.valid_len = valid_len;
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv;
  p.scale = scale;
  p.scale_log2 = scale * vl2_tower::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (D == 128)
    return static_cast<int>(c ? launch<128, true>(p, B, st)
                              : launch<128, false>(p, B, st));
  return static_cast<int>(c ? launch<64, true>(p, B, st)
                            : launch<64, false>(p, B, st));
}
