// K2: causal GQA flash attention, forward, for the LLM prefill.
//
// Replaces videollama2_tpu/ops/flash_attention.py::flash_attention (Pallas
// `_flash_kernel`, with its optional LSE output): q [B, Sq, Hq, D],
// k/v [B, Sk, Hkv, D] bf16, query head h reads kv head h / (Hq / Hkv),
// keys at or past valid_len[b] and (causal) above the diagonal are masked,
// m/l/acc stay fp32, and a row with valid_len == 0 returns mean(v). With a
// non-null `lse` the kernel also stores each row's m + log(l) as fp32
// [B, Hq, Sq] (the residual of the training backward, flash_attention_bwd.cu;
// the Pallas kernel's 128-lane broadcast of it was a TPU layout rule and is
// not kept). The serving path passes null and does no extra work.
//
// What bounds it on the H100: at the Mistral prefill (Sq = Sk = 1664, D 128,
// 32 query heads on 8 kv heads) the products are ~2 * Sq * Sk * D FLOPs per
// head after causal skipping against 4 * S * D bytes, far above the ridge:
// it is tensor-core bound. The design keeps the scores in registers (P is
// fed straight back as the A operand of the PV product), skips key tiles
// above the diagonal and past valid_len, and launches the heaviest (last)
// query tiles first so the causal triangle's long rows do not trail.

#include "attention_tile.cuh"

namespace {

template <int DK, bool kCausal>
__global__ void __launch_bounds__(vl2::kThreads)
    flash_attention_kernel(vl2::AttnParams p) {
  __shared__ __align__(16) __nv_bfloat16 ks[vl2::kBlockK * (DK + 8)];
  __shared__ __align__(16) __nv_bfloat16 vs[vl2::kBlockK * (DK + 8)];
  const int qtile = kCausal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  vl2::attention_tile<DK, kCausal>(p, qtile, blockIdx.y, blockIdx.z, ks, vs);
}

template <int DK>
void launch(const vl2::AttnParams& p, bool causal, cudaStream_t st) {
  const dim3 grid((p.Sq + vl2::kBlockQ - 1) / vl2::kBlockQ, p.Hq, p.B);
  if (causal)
    flash_attention_kernel<DK, true><<<grid, vl2::kThreads, 0, st>>>(p);
  else
    flash_attention_kernel<DK, false><<<grid, vl2::kThreads, 0, st>>>(p);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers; strides are in elements; the last axis of q/k/v is contiguous.
extern "C" int vl2_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* valid_len, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, void* stream) {
  vl2::AttnParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.valid_len = valid_len;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    launch<128>(p, causal != 0, st);
  } else if (D == 64) {
    launch<64>(p, causal != 0, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
