// K1: non-causal attention for the vision towers.
//
// Replaces videollama2_tpu/ops/encoder_attention.py::encoder_attention
// (Pallas `_kernel`): q/k/v [B, S, H, D] bf16 with equal head counts,
// S <= 1024, a key-column mask from valid_len (-1e30 for masked keys), fp32
// scores and softmax, bf16 output.
//
// What bounds it on the H100: at CLIP-L shapes (S 577, D 64, 16 heads,
// 128 frames a chunk) the two products are 4 * S^2 * D FLOPs per head
// against 4 * S * D bytes of q/k/v, ~300 FLOPs a byte, so it sits at the
// tensor-core ridge, and a materialized [S, S] fp32 score matrix (what the
// plain version writes) would make it bandwidth-bound. The Pallas kernel kept
// whole-row scores in VMEM; a Hopper block's 227 KB cannot hold a 577 x 577
// fp32 tile beside K and V, so this kernel tiles queries by 64 and keys by 64
// with an online softmax (attention_tile.cuh) and never writes scores. The
// ragged edge (577 = 9 * 64 + 1) is masked in the kernel instead of padding
// the token axis. D 72 (SigLIP) is computed at a zero-padded 80.

#include "attention_tile.cuh"

namespace {

template <int DK>
__global__ void __launch_bounds__(vl2::kThreads)
    encoder_attention_kernel(vl2::AttnParams p) {
  __shared__ __align__(16) __nv_bfloat16 ks[vl2::kBlockK * (DK + 8)];
  __shared__ __align__(16) __nv_bfloat16 vs[vl2::kBlockK * (DK + 8)];
  vl2::attention_tile<DK, false>(p, blockIdx.x, blockIdx.y, blockIdx.z, ks,
                                 vs);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers; strides are in elements; the last axis of q/k/v is contiguous.
extern "C" int vl2_encoder_attention(
    const void* q, const void* k, const void* v, void* o,
    const int* valid_len, int B, int S, int H, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
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
  const dim3 grid((S + vl2::kBlockQ - 1) / vl2::kBlockQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    encoder_attention_kernel<64><<<grid, vl2::kThreads, 0, st>>>(p);
  } else if (D == 72) {
    encoder_attention_kernel<80><<<grid, vl2::kThreads, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
