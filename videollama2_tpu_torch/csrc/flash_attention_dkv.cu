// K9: the backward of causal GQA flash attention, dk and dv, for training.
//
// Replaces the dk/dv Pallas kernel of
// videollama2_tpu/ops/flash_attention.py::flash_attention_bwd
// (`_flash_bwd_dkv_kernel`). Layouts: q [B, Sq, Hq, D] and k/v
// [B, Sk, Hkv, D] bf16 read through their strides (views of the fused qkv
// projection); do contiguous [B, Sq, Hq, D] bf16; lse (K2's, natural log)
// and delta (K8's, rowsum(do * o)) fp32 [B, Hq, Sq]; dk/dv contiguous bf16
// [B, Sk, Hkv, D]. With fp32 scores and sums and bf16 operands to every
// product:
//   p_ij  = mask_ij ? exp(q_i k_j^T * scale - lse_i) : 0
//   ds_ij = p_ij * (do_i v_j^T - delta_i) * scale
//   dk_j  = sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i,
// summed over the Hq / Hkv query heads of kv head j's group in fp32 and
// rounded once. The mask is explicit (key < valid_len, and key <= query
// when causal): a fully masked row carries lse = -1e30, where exp(s - lse)
// would overflow, so its gradients are exactly zero, as in the Pallas
// kernel.
//
// What bounds it on the H100: at the training shape (q [8, 2048, 32, 128],
// k/v [8, 2048, 8, 128], causal) its four products are 8 * D FLOPs a
// visible (query, key) pair (5.5e11 FLOPs) against ~0.3 GB: tensor-core
// bound. The design is FlashAttention-3's backward without dq (K8 computes
// dq apart, and delta with it):
//
// - Blocks. A block owns 128 keys of one kv head and one batch row, as two
//   m64 tiles, one a consumer warpgroup; their K and V tiles stay resident
//   in shared memory. It loops over the group's query heads, in a fixed
//   order, and over each head's 64-row query tiles from the key tile's
//   diagonal on. No atomics: every dk/dv row is written by one block, and
//   the result is the same from call to call. Causal grids run the key
//   tiles from the first (the heaviest: they see the most queries), over
//   every kv head and batch row of a tile before the next.
// - Warp roles. Warpgroup 0 is the producer (setmaxnreg 40): its first
//   thread TMA-loads K and V once and each step's Q and dO tiles into a
//   ring of kStages stages; its second warp copies the step's 64 lse
//   (times log2 e; +inf past Sq, so those rows give p = 0) and delta
//   values into the same stage and arrives on its barrier. Warpgroups 1
//   and 2 (232 registers) compute.
// - Products on wgmma, a step: S^T = K Q^T and dP^T = V dO^T (m64 n64,
//   both operands in shared memory), then P^T = exp2(S^T * scale log2 e -
//   lse log2 e) under the mask and dS^T = P^T (dP^T - delta) scale in
//   registers (lse and delta read from shared memory by each fragment's
//   query column), then dV += P^T dO and dK += dS^T Q with A from
//   registers and dO and Q as the MN-major B operand (N = D spans the two
//   64-wide boxes at D 128). dK and dV (64 fp32 a thread each at D 128)
//   stay in registers across the whole loop.
// - Masks only where needed: the two query tiles that cross the key tile's
//   diagonal and every step of a key tile that reaches past valid_len; the
//   flag changes only the elementwise pass, so no wgmma is issued under a
//   branch. Key tiles wholly past valid_len visit no query and store zeros.

#include <cuda.h>

#include "hopper_async.cuh"
#include "tower_softmax.cuh"  // ex2, kLog2e, p_fragment

namespace {

using bf16 = __nv_bfloat16;
using namespace vl2_hop;

constexpr int kBlockN = 128;       // keys a block (two m64 tiles)
constexpr int kBlockM = 64;        // query rows a step
constexpr int kNq = kBlockM / 8;   // n8 tiles of a step's query columns
constexpr int kThreads = 3 * 128;  // the producer and two consumer groups
constexpr int kConsumerWarps = 8;
constexpr int kStages = 4;         // Q/dO tiles in the ring
constexpr int kRowThreads = 32;    // the producer's warp 1: lse and delta
// registers a thread after reallocation, within the 168 x 384 = 64,512 the
// block is launched with (128 x 40 + 256 x 232): a warpgroup that asks for
// more than the others gave up waits in setmaxnreg for ever
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct DkvParams {
  CUtensorMap q, dout;   // boxes of 64 lanes x 64 rows, 128-byte swizzle
  CUtensorMap k, v;      // boxes of 64 lanes x 128 rows
  const float* lse;      // [B, Hq, Sq]
  const float* delta;    // [B, Hq, Sq]
  bf16* dk;              // contiguous [B, Sk, Hkv, D]
  bf16* dv;
  const int* valid_len;  // [B], or nullptr (= Sk)
  int Sq, Sk, Hq, Hkv;
  float scale, scale_log2;
};

// Dynamic shared memory, from a 1024-byte-aligned base (bytes): K and V
// (DK / 64 boxes of [128 keys][64 lanes] each), then kStages stages of Q,
// dO (DK / 64 boxes of [64 rows][64 lanes] each) and the step's lse and
// delta rows (64 fp32 each).
template <int DK>
struct Layout {
  static constexpr int kBoxes = DK / 64;
  static constexpr int kKVBox = kBlockN * 128;
  static constexpr int kQBox = kBlockM * 128;
  static constexpr int kV = kBoxes * kKVBox;
  static constexpr int kRing = 2 * kBoxes * kKVBox;
  // within a stage
  static constexpr int kDO = kBoxes * kQBox;
  static constexpr int kRows = 2 * kBoxes * kQBox;
  static constexpr uint32_t kTx = kRows;  // the stage's TMA bytes
  static constexpr int kStage = (kRows + 2 * kBlockM * 4 + 1023) / 1024 * 1024;
  static constexpr int kBytes = kRing + kStages * kStage;
  static_assert(kV % 1024 == 0 && kRing % 1024 == 0 && kDO % 1024 == 0,
                "swizzled tiles need 1024-byte-aligned bases");
};

struct Barriers {
  uint64_t kv_full, full[kStages], empty[kStages];
};

// The block's steps: (query head, query tile) pairs in order, none for a
// key tile wholly at or past valid_len (every p is 0 there).
struct Steps {
  int n_qt, qt_begin, n;
  __device__ Steps(int k0, int valid, int Sq, int G, bool causal) {
    const int n_q = (Sq + kBlockM - 1) / kBlockM;
    // causal: the first query tile that sees key k0 holds row k0
    qt_begin = causal ? k0 / kBlockM : 0;
    n_qt = n_q > qt_begin ? n_q - qt_begin : 0;
    n = k0 < valid ? G * n_qt : 0;
  }
  __device__ __forceinline__ int head(int j) const { return j / n_qt; }
  __device__ __forceinline__ int q0(int j) const {
    return (qt_begin + j % n_qt) * kBlockM;
  }
};

template <int DK, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  using L = Layout<DK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ Barriers bar;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockN;
  const int G = p.Hq / p.Hkv;
  int valid = p.valid_len ? p.valid_len[b] : p.Sk;
  valid = valid < 0 ? 0 : (valid > p.Sk ? p.Sk : valid);
  const Steps steps(k0, valid, p.Sq, G, kCausal);

  if (threadIdx.x == 0) {
    mbar_init(&bar.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full[s], 1 + kRowThreads);
      mbar_init(&bar.empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer group
    release_registers<kProducerRegs>();
    if (threadIdx.x == 0 && steps.n > 0) {
      mbar_expect_tx(&bar.kv_full, L::kRing);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load_4d(smem + x * L::kKVBox, &p.k, &bar.kv_full, 64 * x, k0,
                    kvh, b);
        tma_load_4d(smem + L::kV + x * L::kKVBox, &p.v, &bar.kv_full,
                    64 * x, k0, kvh, b);
      }
      for (int j = 0; j < steps.n; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&bar.empty[s], (j / kStages - 1) & 1);
        unsigned char* st = smem + L::kRing + s * L::kStage;
        const int h = kvh * G + steps.head(j), q0 = steps.q0(j);
        mbar_expect_tx(&bar.full[s], L::kTx);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load_4d(st + x * L::kQBox, &p.q, &bar.full[s], 64 * x, q0, h,
                      b);
          tma_load_4d(st + L::kDO + x * L::kQBox, &p.dout, &bar.full[s],
                      64 * x, q0, h, b);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 32 + kRowThreads) {
      const int lane = threadIdx.x - 32;
      for (int j = 0; j < steps.n; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&bar.empty[s], (j / kStages - 1) & 1);
        float* rows =
            reinterpret_cast<float*>(smem + L::kRing + s * L::kStage + L::kRows);
        const int h = kvh * G + steps.head(j), q0 = steps.q0(j);
        const long long base = ((long long)b * p.Hq + h) * p.Sq;
        for (int i = lane; i < kBlockM; i += kRowThreads) {
          const bool in = q0 + i < p.Sq;
          rows[i] = in ? p.lse[base + q0 + i] * vl2_tower::kLog2e : INFINITY;
          rows[kBlockM + i] = in ? p.delta[base + q0 + i] : 0.f;
        }
        mbar_arrive(&bar.full[s]);
      }
    }
    return;
  }

  claim_registers<kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, wl = (threadIdx.x / 32) % 4;
  const int t = lane & 3;
  // this thread's keys: key0 and key0 + 8
  const int key0 = k0 + c * 64 + wl * 16 + (lane >> 2);
  float dk[DK / 8][4], dv[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (steps.n > 0) {
    const uint64_t ka = make_desc(smem + c * 64 * 128, 16, 1024,
                                  kSwizzle128B);
    const uint64_t va = make_desc(smem + L::kV + c * 64 * 128, 16, 1024,
                                  kSwizzle128B);
    mbar_wait(&bar.kv_full, 0);
    for (int j = 0; j < steps.n; ++j) {
      const int s = j % kStages;
      const unsigned char* st = smem + L::kRing + s * L::kStage;
      const float* lse2 = reinterpret_cast<const float*>(st + L::kRows);
      const float* delta = lse2 + kBlockM;
      const int q0 = steps.q0(j);
      const bool masked =
          (kCausal && q0 < k0 + kBlockN) || k0 + kBlockN > valid;
      mbar_wait(&bar.full[s], (j / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T (Q and dO K-major)
      float sp[kNq][4], dp[kNq][4];
      const uint64_t qb = make_desc(st, 16, 1024, kSwizzle128B);
      const uint64_t db = make_desc(st + L::kDO, 16, 1024, kSwizzle128B);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DK / 16; ++kc) {
        const int at = (kc / 4) * L::kKVBox + (kc % 4) * 32;
        const int bt = (kc / 4) * L::kQBox + (kc % 4) * 32;
        wgmma_ss<kBlockM>(sp, ka + (at >> 4), qb + (bt >> 4), kc > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < DK / 16; ++kc) {
        const int at = (kc / 4) * L::kKVBox + (kc % 4) * 32;
        const int bt = (kc / 4) * L::kQBox + (kc % 4) * 32;
        wgmma_ss<kBlockM>(dp, va + (at >> 4), db + (bt >> 4), kc > 0);
      }
      wgmma_commit();

      // P^T while dP^T runs
      wgmma_wait<1>();
      fence_regs<kNq * 4>(&sp[0][0]);
#pragma unroll
      for (int n = 0; n < kNq; ++n) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse2 + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = vl2_tower::ex2(
              fmaf(sp[n][e], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (masked) {
            const int query = q0 + n * 8 + 2 * t + (e & 1);
            const int key = key0 + (e >> 1) * 8;
            const bool keep = key < valid && (!kCausal || key <= query);
            pe = keep ? pe : 0.f;
          }
          sp[n][e] = pe;
        }
      }
      wgmma_wait<0>();
      fence_regs<kNq * 4>(&dp[0][0]);
      uint32_t pf[kBlockM / 16][4], sf[kBlockM / 16][4];
#pragma unroll
      for (int n = 0; n < kNq; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = sp[n][e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x)) *
                     p.scale;  // dS^T
      }
#pragma unroll
      for (int kc = 0; kc < kBlockM / 16; ++kc) {
        vl2_tower::p_fragment(sp, kc, pf[kc]);
        vl2_tower::p_fragment(dp, kc, sf[kc]);
      }

      // dV += P^T dO and dK += dS^T Q (dO and Q MN-major)
      const uint64_t dmn = make_desc(st + L::kDO, L::kQBox, 1024,
                                     kSwizzle128B);
      const uint64_t qmn = make_desc(st, L::kQBox, 1024, kSwizzle128B);
      fence_regs<(DK / 8) * 4>(&dv[0][0]);
      fence_regs<(DK / 8) * 4>(&dk[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBlockM / 16; ++kc) {
        wgmma_rs<DK>(dv, pf[kc], dmn + kc * (16 * 128 >> 4));
        wgmma_rs<DK>(dk, sf[kc], qmn + kc * (16 * 128 >> 4));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<(DK / 8) * 4>(&dv[0][0]);
      fence_regs<(DK / 8) * 4>(&dk[0][0]);
      fence_regs<(kBlockM / 16) * 4>(&pf[0][0]);
      fence_regs<(kBlockM / 16) * 4>(&sf[0][0]);
      // the consumer warps are done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar.empty[s]);
    }
  }

  // this thread's rows key0 and key0 + 8 (rows past Sk are not stored;
  // zeros for a key tile past valid_len)
  const long long kv_row = (long long)p.Hkv * DK;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= p.Sk) continue;
    const long long off = ((long long)b * p.Sk + key) * kv_row + kvh * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int d = n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + d) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + d) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// Sets the kernel's shared memory once and launches it over (kv head,
// batch row, key tile).
template <int DK, bool kCausal>
cudaError_t launch(const DkvParams& p, int B, cudaStream_t st) {
  constexpr int kSmem = Layout<DK>::kBytes + 1024;  // + the base alignment
  auto kernel = flash_bwd_dkv_kernel<DK, kCausal>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(p.Hkv, B, (p.Sk + kBlockN - 1) / kBlockN);
  kernel<<<grid, kThreads, kSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K9: dk and dv from K8's delta. Returns the cudaError_t of the launch (0
// on success). Pointers are device pointers; strides are in elements,
// every stride and base a multiple of 16 bytes (TMA takes nothing else);
// the last axis of q/k/v is contiguous; do contiguous [B, Sq, Hq, D]. D 64
// or 128 and Hq % Hkv == 0; anything else, or a view TMA refuses, returns
// cudaErrorInvalidValue before any launch.
extern "C" int vl2_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const int* valid_len, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, void* stream) {
  if ((D != 64 && D != 128) || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  DkvParams p;
  const long long o_ss = (long long)Hq * D;
  if (!make_map(&p.q, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, 64, kBlockM, 1,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.dout, dout, B, Sq, Hq, D, Sq * o_ss, o_ss, D, 64, kBlockM,
                1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.k, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, 64, kBlockN, 1,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p.v, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, 64, kBlockN, 1,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
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
