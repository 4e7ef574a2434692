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
// so such a row's gradients are exactly zero, as in the Pallas kernel.
//
// Delta: K8 computes delta once per query row, from its dO tile and o, and
// stores it as fp32 [B, Hq, Sq]; K9 (flash_attention_dkv.cu, launched after
// K8 on the same stream) reads it instead of recomputing it for every key
// tile. There is no separate delta pass.
//
// Grid: one block per (64-row query tile, query head, batch row), heaviest
// (last) causal tiles first, looping over the key tiles up to the diagonal
// and valid_len.
//
// What bounds it on the H100: at the training shape (q [8, 2048, 32, 128],
// k/v [8, 2048, 8, 128], causal) its 3 products of 2 * S^2/2 * D FLOPs per
// query head (4.1e11 FLOPs) against ~0.3 GB of inputs: tensor-core bound.
// It keeps the score tiles in registers and feeds them back as the A
// operand of the next product, skips tiles above the diagonal and past
// valid_len, and holds the four 64-row operand tiles (q, do, k, v) in
// padded shared memory for ldmatrix. Each warp owns 16 query rows and
// their fp32 dq accumulators. The operand tiles are loaded synchronously;
// K9's TMA and wgmma design is the model for its redesign.

#include "attention_tile.cuh"

namespace {

using vl2::kBlockK;
using vl2::kBlockQ;
using vl2::kThreads;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;     // contiguous [B, Sq, Hq, D]
  const __nv_bfloat16* dout;  // contiguous [B, Sq, Hq, D]
  const float* lse;           // [B, Hq, Sq]
  float* delta;               // [B, Hq, Sq]: written by K8, read by K9
  __nv_bfloat16* dq;          // contiguous [B, Sq, Hq, D]
  const int* valid_len;       // [B], or nullptr (= Sk)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, Sq, Sk, Hq, Hkv, D;
  float scale;
};

template <int DK>
__host__ __device__ constexpr int tile_elems() { return kBlockK * (DK + 8); }

template <int DK>
constexpr size_t smem_bytes() {
  return 4 * tile_elems<DK>() * sizeof(__nv_bfloat16);
}

// acc[n] (16 rows x 64 columns, n8 tiles) = A (this warp's 16 rows of tile
// `a`) times B^T, B = the 64 rows of tile `bt`; both [64, DK + 8] bf16.
template <int DK>
__device__ __forceinline__ void mma_abt(float (&acc)[kBlockK / 8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* bt) {
  constexpr int kRow = DK + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < kBlockK / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DK / 16; ++kc) {
    uint32_t af[4];
    vl2::ldsm_x4(af[0], af[1], af[2], af[3],
                 a + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                     kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kBlockK / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      vl2::ldsm_x4(b0, b1, b2, b3,
                   bt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kRow +
                       kc * 16 + ((lane >> 3) & 1) * 8);
      vl2::mma_bf16(acc[2 * np], af, b0, b1);
      vl2::mma_bf16(acc[2 * np + 1], af, b2, b3);
    }
  }
}

// out[n] (16 rows x DK) += P (16 rows x 64, fp32 accumulators rounded to
// bf16: the A fragment of a k16 chunk is two n8 accumulator tiles) times
// the 64 x DK tile `b` (read transposed by ldmatrix).
template <int DK>
__device__ __forceinline__ void mma_pb(float (&out)[DK / 8][4],
                                       const float (&pm)[kBlockK / 8][4],
                                       const __nv_bfloat16* b) {
  constexpr int kRow = DK + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < kBlockK / 16; ++kc) {
    uint32_t a[4];
    a[0] = vl2::pack_bf16(pm[2 * kc][0], pm[2 * kc][1]);
    a[1] = vl2::pack_bf16(pm[2 * kc][2], pm[2 * kc][3]);
    a[2] = vl2::pack_bf16(pm[2 * kc + 1][0], pm[2 * kc + 1][1]);
    a[3] = vl2::pack_bf16(pm[2 * kc + 1][2], pm[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < DK / 16; ++dp) {
      uint32_t b0, b1, b2, b3;
      vl2::ldsm_x4_trans(b0, b1, b2, b3,
                         b + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kRow + dp * 16 + (lane >> 4) * 8);
      vl2::mma_bf16(out[2 * dp], a, b0, b1);
      vl2::mma_bf16(out[2 * dp + 1], a, b2, b3);
    }
  }
}

// Store rows row0 and row0 + 8 of a warp's [16, DK] fp32 accumulator as
// bf16 rows of `dst` (row r at dst + r * row_stride), rows >= n_rows skipped.
template <int DK>
__device__ __forceinline__ void store_rows(const float (&acc)[DK / 8][4],
                                           __nv_bfloat16* dst,
                                           long long row_stride, int row0,
                                           int n_rows) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * row_stride + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

__device__ __forceinline__ int clamp_valid(const BwdParams& p, int b) {
  const int valid = p.valid_len ? p.valid_len[b] : p.Sk;
  return valid < 0 ? 0 : (valid > p.Sk ? p.Sk : valid);
}

// K8: dq for query rows [qtile * 64, +64) of head h in batch row b.
template <int DK, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + tile_elems<DK>();
  __nv_bfloat16* ks = dos + tile_elems<DK>();
  __nv_bfloat16* vs = ks + tile_elems<DK>();
  constexpr int kRow = DK + 8;
  constexpr int kNs = kBlockK / 8;
  const int qtile = kCausal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qtile * kBlockQ;
  const int qrows = min(kBlockQ, p.Sq - q0);
  const int kvh = h / (p.Hq / p.Hkv);
  const int valid = clamp_valid(p, b);
  const long long o_row = (long long)p.Hq * p.D;  // o/do/dq row stride
  const long long o_base = ((long long)b * p.Sq + q0) * o_row + h * p.D;
  const long long lse_base = ((long long)b * p.Hq + h) * p.Sq;

  vl2::load_tile<DK>(qs, p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss,
                     qrows, p.D);
  vl2::load_tile<DK>(dos, p.dout + o_base, o_row, qrows, p.D);
  __syncthreads();

  // delta for this thread's rows (lr, lr + 8 of the tile): the quad splits
  // the head dim in 16-byte chunks; lse alongside.
  float delta[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + r * 8;
    float s = 0.f;
    if (lr < qrows) {
      const __nv_bfloat16* orow = p.o + o_base + lr * o_row;
      for (int c = t * 8; c < p.D; c += 32) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dos + lr * kRow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          s += of.x * df.x + of.y * df.y;
        }
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    delta[r] = s;
    lse[r] = lr < qrows ? p.lse[lse_base + q0 + lr] : 0.f;
    if (t == 0 && lr < qrows) p.delta[lse_base + q0 + lr] = s;
  }

  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // Key tiles wholly past valid_len (all of them when valid_len == 0) or,
  // causal, above the diagonal give p == 0: skip them.
  int n_tiles = min((p.Sk + kBlockK - 1) / kBlockK,
                    (valid + kBlockK - 1) / kBlockK);
  if (kCausal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);
  const int row0 = q0 + warp * 16 + g;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const int krows = min(kBlockK, p.Sk - k0);
    __syncthreads();  // every warp is done with the previous k/v tiles
    vl2::load_tile<DK>(ks, p.k + b * p.k_sb + k0 * p.k_ss + kvh * p.k_sh,
                       p.k_ss, krows, p.D);
    vl2::load_tile<DK>(vs, p.v + b * p.v_sb + k0 * p.v_ss + kvh * p.v_sh,
                       p.v_ss, krows, p.D);
    __syncthreads();

    float s[kNs][4], dp[kNs][4];
    mma_abt<DK>(s, qs, ks);    // q k^T
    mma_abt<DK>(dp, dos, vs);  // do v^T
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        bool keep = col < valid && row < p.Sq;
        if (kCausal) keep = keep && col <= row;
        const float pe =
            keep ? __expf(s[n][e] * p.scale - lse[e >> 1]) : 0.f;
        s[n][e] = pe * (dp[n][e] - delta[e >> 1]) * p.scale;  // ds
      }
    }
    mma_pb<DK>(acc, s, ks);  // dq += ds k
  }

  store_rows<DK>(acc, p.dq + o_base, o_row, warp * 16 + g, qrows);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                   const BwdParams& p) {
  // above 48 KB, dynamic shared memory needs the kernel's opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_dq(const BwdParams& p, bool causal, cudaStream_t st) {
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.Hq, p.B);
  return causal
             ? launch(flash_bwd_dq_kernel<DK, true>, grid, smem_bytes<DK>(),
                      st, p)
             : launch(flash_bwd_dq_kernel<DK, false>, grid, smem_bytes<DK>(),
                      st, p);
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, const int* valid_len, int B, int Sq,
                      int Sk, int Hq, int Hkv, int D, long long q_sb,
                      long long q_ss, long long q_sh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, float scale) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.valid_len = valid_len;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.scale = scale;
  return p;
}

}  // namespace

// K8: dq and delta. Returns the cudaError_t of the launch (0 on success).
// Pointers are device pointers; strides are in elements; the last axis of
// q/k/v is contiguous; o/do contiguous [B, Sq, Hq, D]; lse/delta
// [B, Hq, Sq].
extern "C" int vl2_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq,
    const int* valid_len, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, void* stream) {
  BwdParams p = make_params(q, k, v, o, dout, lse, delta, valid_len, B, Sq,
                            Sk, Hq, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss,
                            k_sh, v_sb, v_ss, v_sh, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch_dq<128>(p, causal != 0, st));
  if (D == 64) return static_cast<int>(launch_dq<64>(p, causal != 0, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
