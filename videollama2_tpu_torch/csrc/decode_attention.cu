// K3: one-token GQA decode attention over layer `layer` of the stacked KV
// cache, seeded with the new token's k/v.
//
// Replaces videollama2_tpu/ops/decode_attention.py::decode_attention_layered
// (Pallas `_kernel`): q [B, H, hd] bf16; k_new/v_new [B, Hkv, hd] bf16 (the
// current token, not in the cache yet); cache [L, B, M, Hkv * hd], int8 with
// per-row fp32 scales [L, B, Hkv, M] or bf16 without. A cache row `col` is
// kept when col < valid_len[b] or prompt_len <= col < write_pos, and, with a
// window, when the logical query position minus the row's logical position
// is below it. The k scale multiplies the scores before masking; the v scale
// folds into p, which is rounded to bf16 before the PV product; softmax
// state is fp32; query head h reads kv head h / (H / Hkv). The new token
// enters as the seed of the softmax state (m = q . k_new * scale, l = 1,
// acc = v_new), so row write_pos is never read from the cache.
//
// What bounds it on the H100: bandwidth. At the slice's shape (B 16, Hkv 8,
// hd 128, M 1792, int8) a call reads ~59 MB of cache for ~0.1 GFLOP. One
// block per (b, kv head) would give 128 blocks for 132 SMs, each streaming
// 460 KB alone. So the cache rows [0, write_pos) are split into chunks of
// 128 rows, one block each (~1,800 blocks at the slice's shape; masked rows
// are not loaded): a block scores its rows for the G query heads of its kv
// head on CUDA cores (8 lanes a row, 16 bytes a lane), keeps the chunk's
// softmax state (m, l, acc) in fp32, and a second launch merges the chunks'
// states with the seed and normalises. Scale rows are read with the cache
// rows' stride M; the output rounding matches the Pallas kernel's.
//
// The group G (query heads a kv head: 1, 2, 4, 7 or 8) is a template
// argument and need not be a power of two: it sizes per-thread registers
// (qr[G][hd / 8], 112 floats at G 7 and hd 128) and shared arrays (s_p[G],
// s_red[G * HD]), the softmax phase gives warp w heads w, w + 4, ..., and
// the PV phase's row split and the merge loop do not depend on it.
//
// Known limit (later work): measured on an H100 at 700 W, a call at the
// slice's shape takes ~0.29 ms, ~0.2 TB/s. The PV phase reads V one byte (a
// bf16 cache: two) a thread, 32 bytes a warp request, so too few bytes are
// in flight; 16-byte lanes there, as in the score phase, are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // cache rows per block of the split launch

struct DecodeParams {
  const __nv_bfloat16* q;      // [B, H, hd]
  const __nv_bfloat16* k_new;  // [B, Hkv, hd]
  const __nv_bfloat16* v_new;
  const void* cache_k;         // layer base, [B, M, Hkv * hd]
  const void* cache_v;
  const float* k_scale;        // layer base, [B, Hkv, M]; null for bf16
  const float* v_scale;
  const int* valid_len;        // [B]
  __nv_bfloat16* out;          // [B, H, hd]
  float* part_acc;             // [B, Hkv, nsplit, G, hd]
  float* part_ml;              // [B, Hkv, nsplit, G, 2]: chunk max, sum
  int B, H, Hkv, M, nsplit, write_pos, prompt_len, window;
  float scale;
};

__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive cache elements (N = 8 or 16) as floats; src is aligned to
// N elements.
template <int N>
__device__ __forceinline__ void load_row(const int8_t* src, float (&f)[N]) {
  if constexpr (N == 16) {
    const int4 v = *reinterpret_cast<const int4*>(src);
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  } else {
    const int2 v = *reinterpret_cast<const int2*>(src);
    const int w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* src,
                                         float (&f)[N]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + c * 8);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[c * 8 + 2 * i] = t.x;
      f[c * 8 + 2 * i + 1] = t.y;
    }
  }
}

__device__ __forceinline__ bool keep_row(const DecodeParams& p, int col,
                                         int valid) {
  bool keep = col < valid || (col >= p.prompt_len && col < p.write_pos);
  if (p.window >= 0) {
    const int q_pos = valid + (p.write_pos - p.prompt_len);
    const int logical = col < p.prompt_len ? col : valid + (col - p.prompt_len);
    keep = keep && (q_pos - logical < p.window);
  }
  return keep;
}

// One block: cache rows [split * kChunk, +kChunk) ∩ [0, write_pos) of kv head
// blockIdx.y in batch row blockIdx.z, for its G query heads.
template <int HD, int G, typename T>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(DecodeParams p) {
  constexpr int kEPL = HD / 8;          // elements a lane, 8 lanes a row
  constexpr int kGroups = kThreads / HD;  // row groups of the PV phase
  __shared__ float s_p[G][kChunk];      // scores, then bf16-rounded p * vs
  __shared__ int s_keep[kChunk];
  __shared__ float s_red[kGroups > 1 ? G * HD : 1];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = split * kChunk;
  const int rows = min(kChunk, p.write_pos - r0);
  const int valid = p.valid_len[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row_stride = static_cast<long long>(p.Hkv) * HD;
  const T* kbase = static_cast<const T*>(p.cache_k) +
                   static_cast<long long>(b) * p.M * row_stride + kvh * HD;
  const T* vbase = static_cast<const T*>(p.cache_v) +
                   static_cast<long long>(b) * p.M * row_stride + kvh * HD;
  const long long srow = (static_cast<long long>(b) * p.Hkv + kvh) * p.M;

  // Scores: lane group (lane / 8) takes a row, lane % 8 its kEPL columns.
  const int part = lane & 7, rsub = lane >> 3;
  float qr[G][kEPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_row<kEPL>(p.q + (static_cast<long long>(b) * p.H + kvh * G + g) * HD +
                       part * kEPL,
                   qr[g]);
  for (int rr = warp * 4 + rsub; rr < kChunk; rr += kWarps * 4) {
    const int col = r0 + rr;
    const bool keep = rr < rows && keep_row(p, col, valid);
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (keep) {
      float kf[kEPL];
      load_row<kEPL>(kbase + col * row_stride + part * kEPL, kf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kEPL; ++e) s[g] = fmaf(qr[g][e], kf[e], s[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 4);
    }
    if (part == 0) {
      const float ks = p.k_scale ? p.k_scale[srow + (keep ? col : 0)] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g)
        s_p[g][rr] = keep ? s[g] * p.scale * ks : -INFINITY;
      s_keep[rr] = keep;
    }
  }
  __syncthreads();

  // Chunk softmax per query head: max, p = exp(s - max), sum; p * vs is
  // rounded to bf16 (the dtype of the PV operands).
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int rr = lane; rr < kChunk; rr += 32) mx = fmaxf(mx, s_p[g][rr]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int rr = lane; rr < kChunk; rr += 32) {
      const float sc = s_p[g][rr];
      float pe = 0.f, pin = 0.f;
      if (sc != -INFINITY) {
        pe = expf(sc - mx);
        pin = p.v_scale ? pe * p.v_scale[srow + r0 + rr] : pe;
      }
      l += pe;
      s_p[g][rr] = __bfloat162float(__float2bfloat16(pin));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      float* ml = p.part_ml +
                  (((static_cast<long long>(b) * p.Hkv + kvh) * p.nsplit +
                    split) * G + g) * 2;
      ml[0] = mx;
      ml[1] = l;
    }
  }
  __syncthreads();

  // acc[g][d] = sum over kept rows of p_in[g][row] * v[row][d].
  const int d = threadIdx.x % HD, grp = threadIdx.x / HD;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 4
  for (int rr = grp; rr < rows; rr += kGroups) {
    if (!s_keep[rr]) continue;
    const float vv = to_float(vbase[(r0 + rr) * row_stride + d]);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = fmaf(s_p[g][rr], vv, acc[g]);
  }
  if constexpr (kGroups > 1) {
    if (grp == 1)
#pragma unroll
      for (int g = 0; g < G; ++g) s_red[g * HD + d] = acc[g];
    __syncthreads();
    if (grp != 0) return;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] += s_red[g * HD + d];
  }
  float* pa = p.part_acc +
              ((static_cast<long long>(b) * p.Hkv + kvh) * p.nsplit + split) *
                  G * HD;
#pragma unroll
  for (int g = 0; g < G; ++g) pa[g * HD + d] = acc[g];
}

// One block of HD threads per (kv head, batch row): the seed's score, then
// the merge of every chunk's (m, l, acc) with the seed, then out = acc / l.
template <int HD, int G>
__global__ void __launch_bounds__(HD) decode_combine_kernel(DecodeParams p) {
  __shared__ float red[HD / 32];
  const int kvh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int warp = d / 32, lane = d % 32;
  const long long nrow = (static_cast<long long>(b) * p.Hkv + kvh) * HD + d;
  const float kn = __bfloat162float(p.k_new[nrow]);
  const float vn = __bfloat162float(p.v_new[nrow]);
  const long long base = (static_cast<long long>(b) * p.Hkv + kvh) * p.nsplit;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    float prod = __bfloat162float(p.q[(static_cast<long long>(b) * p.H + h) *
                                          HD + d]) * kn;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      prod += __shfl_xor_sync(0xffffffffu, prod, o);
    __syncthreads();  // the previous head is done reading red
    if (lane == 0) red[warp] = prod;
    __syncthreads();
    float s_new = 0.f;
#pragma unroll
    for (int w = 0; w < HD / 32; ++w) s_new += red[w];
    s_new *= p.scale;

    float m = s_new;
    for (int i = 0; i < p.nsplit; ++i)
      m = fmaxf(m, p.part_ml[((base + i) * G + g) * 2]);
    const float w_new = expf(s_new - m);
    float l = w_new, acc = w_new * vn;
    for (int i = 0; i < p.nsplit; ++i) {
      const float* ml = p.part_ml + ((base + i) * G + g) * 2;
      const float w = expf(ml[0] - m);  // 0 for a chunk with no kept row
      l = fmaf(w, ml[1], l);
      acc = fmaf(w, p.part_acc[((base + i) * G + g) * HD + d], acc);
    }
    p.out[(static_cast<long long>(b) * p.H + h) * HD + d] =
        __float2bfloat16(acc / l);
  }
}

template <int HD, int G>
void launch(const DecodeParams& p, bool int8, cudaStream_t st) {
  const dim3 grid(p.nsplit, p.Hkv, p.B);
  if (int8)
    decode_split_kernel<HD, G, int8_t><<<grid, kThreads, 0, st>>>(p);
  else
    decode_split_kernel<HD, G, __nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
  decode_combine_kernel<HD, G><<<dim3(p.Hkv, p.B), HD, 0, st>>>(p);
}

template <int HD>
int launch_hd(const DecodeParams& p, int G, bool int8, cudaStream_t st) {
  switch (G) {
    case 1: launch<HD, 1>(p, int8, st); break;
    case 2: launch<HD, 2>(p, int8, st); break;
    case 4: launch<HD, 4>(p, int8, st); break;
    case 7: launch<HD, 7>(p, int8, st); break;  // Qwen2-7B: 28 on 4
    case 8: launch<HD, 8>(p, int8, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Pointers are device
// pointers to contiguous tensors; cache_k/cache_v/k_scale/v_scale are the
// stacked [L, ...] tensors (k_scale/v_scale null for a bf16 cache), offset
// here to `layer`; part_acc/part_ml are fp32 scratch of
// B * Hkv * nsplit * G * hd and B * Hkv * nsplit * G * 2 floats, with
// nsplit = ceil(write_pos / 128) (at least 1). window < 0 means none.
extern "C" int vl2_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* cache_k,
    const void* cache_v, const void* k_scale, const void* v_scale,
    const void* valid_len, void* out, void* part_acc, void* part_ml, int B,
    int H, int Hkv, int D, int M, int layer, int write_pos, int prompt_len,
    int window, int nsplit, float scale, void* stream) {
  const bool int8 = k_scale != nullptr;
  const long long layer_elems = static_cast<long long>(layer) * B * M * Hkv * D;
  const long long elem = int8 ? 1 : 2;
  DecodeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  p.cache_k = static_cast<const char*>(cache_k) + layer_elems * elem;
  p.cache_v = static_cast<const char*>(cache_v) + layer_elems * elem;
  const long long layer_scales = static_cast<long long>(layer) * B * Hkv * M;
  p.k_scale = int8 ? static_cast<const float*>(k_scale) + layer_scales
                   : nullptr;
  p.v_scale = int8 ? static_cast<const float*>(v_scale) + layer_scales
                   : nullptr;
  p.valid_len = static_cast<const int*>(valid_len);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B; p.H = H; p.Hkv = Hkv; p.M = M; p.nsplit = nsplit;
  p.write_pos = write_pos; p.prompt_len = prompt_len; p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (D == 128) return launch_hd<128>(p, G, int8, st);
  if (D == 64) return launch_hd<64>(p, G, int8, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
