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
// What bounds it on the H100: bandwidth. At the Mistral slice's shape (B 16,
// Hkv 8, hd 128, M 1792, int8) a call reads ~59 MB of cache rows and scales
// for ~0.1 GFLOP, so the only aim is to keep enough bytes in flight to run
// at the memory's rate. The cache rows [0, M) are split into chunks of 128
// rows, one block each (grid from M: a block past write_pos exits at once,
// so the grid and the scratch do not follow the host's write_pos). A block:
//
// - issues its whole chunk as 16-byte cp.async copies into dynamic shared
//   memory at once, K rows as one group and V rows as a second, so V's
//   bytes fly while the scores are computed (32 KB a block int8, 64 KB
//   bf16). Masked rows and rows past write_pos are zero-filled by the copy
//   and cost no device-memory bytes;
// - scores one row a thread (q held in shared memory as fp32, read by
//   broadcast; a thread's registers hold only its G sums and one 16-byte
//   slice of its row), then each warp takes query heads for the chunk's
//   max, p = exp(s - max), the sum, and p * v_scale rounded to bf16;
// - multiplies P V with 8 head-dim lanes a thread (one 8- or 16-byte
//   shared load a row), reduces the row groups through shuffles and
//   shared memory, and writes the chunk's fp32 state (m, l, acc).
//
// A second launch, a block a query head, merges every chunk's state with
// the seed in chunk order and normalises, so two runs give identical
// outputs. The group G (query heads a kv head: 1, 2, 4, 7 or 8) is a
// template argument and need not be a power of two: it sizes shared arrays
// and the per-thread sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using vl2::cp_async16;
using vl2::cp_async_commit;
using vl2::cp_async_wait;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // cache rows a block; == kThreads (row a thread)
static_assert(kChunk == kThreads, "the score phase takes a row a thread");

struct DecodeParams {
  const __nv_bfloat16* q;      // [B, H, hd]
  const __nv_bfloat16* k_new;  // [B, Hkv, hd]
  const __nv_bfloat16* v_new;
  const char* cache_k;         // layer base, [B, M, Hkv * hd]
  const char* cache_v;
  const float* k_scale;        // layer base, [B, Hkv, M]; null for bf16
  const float* v_scale;
  const int* valid_len;        // [B]
  __nv_bfloat16* out;          // [B, H, hd]
  float* part_acc;             // [B, Hkv, nsplit, G, hd]
  float* part_ml;              // [B, Hkv, nsplit, G, 2]: chunk max, sum
  int B, H, Hkv, M, nsplit, write_pos, prompt_len, window;
  float scale;
};

// Shared memory of one block (bytes): the K and V chunks (rows padded by 16
// bytes, so 16-byte loads of consecutive rows hit distinct bank groups),
// q as fp32, the scores / p, the rows' v scales and keep flags. After the
// scores, the K chunk's space holds the PV phase's per-warp partial sums.
template <int HD, int G, typename T>
struct Smem {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  static constexpr int kRow = kRowBytes + 16;
  static constexpr int kKV = kChunk * kRow;
  static constexpr int kQ = 2 * kKV;                    // float [G][HD]
  static constexpr int kP = kQ + G * HD * 4;            // float [G][kChunk]
  static constexpr int kVs = kP + G * kChunk * 4;       // float [kChunk]
  static constexpr int kKeep = kVs + kChunk * 4;        // int [kChunk]
  static constexpr int kBytes = kKeep + kChunk * 4;
  static_assert(kWarps * G * HD * 4 <= kKV, "PV partials fit the K chunk");
};

// 16 bytes of cache elements from shared memory as floats (16 int8 or 8
// bf16 values).
__device__ __forceinline__ void load16b(const int8_t* src, float (&f)[16]) {
  const int4 v = *reinterpret_cast<const int4*>(src);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}

// 8 consecutive cache elements from shared memory as floats.
__device__ __forceinline__ void load8(const int8_t* src, float (&f)[8]) {
  const int2 v = *reinterpret_cast<const int2*>(src);
  const int w[2] = {v.x, v.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load16b(const __nv_bfloat16* src,
                                        float (&f)[8]) {
  load8(src, f);
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
    decode_chunk_kernel(DecodeParams p) {
  using L = Smem<HD, G, T>;
  constexpr int kCopies = L::kRowBytes / 16;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::kKV;
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* s_p = reinterpret_cast<float*>(smem + L::kP);
  float* s_vs = reinterpret_cast<float*>(smem + L::kVs);
  int* s_keep = reinterpret_cast<int*>(smem + L::kKeep);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = split * kChunk;
  if (r0 >= p.write_pos) return;  // past the rows this step reads
  const int rows = min(kChunk, p.write_pos - r0);
  const int valid = p.valid_len[b];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row_bytes = static_cast<long long>(p.Hkv) * L::kRowBytes;
  const long long base = static_cast<long long>(b) * p.M * row_bytes +
                         kvh * L::kRowBytes + r0 * row_bytes;
  const long long srow = (static_cast<long long>(b) * p.Hkv + kvh) * p.M;

  // The chunk's K rows (group 0), then its V rows (group 1).
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const char* src = (part ? p.cache_v : p.cache_k) + base;
    unsigned char* dst = part ? vs : ks;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kCopies, c = idx - r * kCopies;
      const bool ok = r < rows && keep_row(p, r0 + r, valid);
      cp_async16(dst + r * L::kRow + c * 16,
                 ok ? src + r * row_bytes + c * 16 : src, ok);
    }
    cp_async_commit();
  }

  // While they fly: q as fp32, and this thread's row's flag and scales.
  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i] = __bfloat162float(
        p.q[(static_cast<long long>(b) * p.H + kvh * G) * HD + i]);
  const int rr = tid, col = r0 + rr;
  const bool keep = rr < rows && keep_row(p, col, valid);
  const float k_sc = keep && p.k_scale ? p.k_scale[srow + col] : 1.f;
  s_vs[rr] = keep && p.v_scale ? p.v_scale[srow + col] : 1.f;
  s_keep[rr] = keep;
  cp_async_wait<1>();
  __syncthreads();

  // Scores: one row a thread, 16 bytes of it at a time (a row stride of
  // 16 bytes past a multiple of 128 keeps those loads free of bank
  // conflicts).
  {
    constexpr int kE = 16 / static_cast<int>(sizeof(T));
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (keep) {
      const T* krow = reinterpret_cast<const T*>(ks + rr * L::kRow);
#pragma unroll 2
      for (int c = 0; c < HD / kE; ++c) {
        float kf[kE];
        load16b(krow + c * kE, kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < kE; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(
                q_s + g * HD + c * kE + e);
            s[g] = fmaf(qv.x, kf[e], s[g]);
            s[g] = fmaf(qv.y, kf[e + 1], s[g]);
            s[g] = fmaf(qv.z, kf[e + 2], s[g]);
            s[g] = fmaf(qv.w, kf[e + 3], s[g]);
          }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      s_p[g * kChunk + rr] = keep ? s[g] * p.scale * k_sc : -INFINITY;
  }
  __syncthreads();

  // Chunk softmax a query head a warp: max, p = exp(s - max), sum; p * vs
  // is rounded to bf16 (the dtype of the PV operands).
  for (int g = warp; g < G; g += kWarps) {
    float* sp = s_p + g * kChunk;
    float mx = -INFINITY;
#pragma unroll
    for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, sp[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
#pragma unroll
    for (int j = lane; j < kChunk; j += 32) {
      const float sc = sp[j];
      float pe = 0.f, pin = 0.f;
      if (sc != -INFINITY) {
        pe = expf(sc - mx);
        pin = pe * s_vs[j];
      }
      l += pe;
      sp[j] = __bfloat162float(__float2bfloat16(pin));
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
  cp_async_wait<0>();
  __syncthreads();

  // acc[g][d] = sum over kept rows of p_in[g][row] * v[row][d]: thread
  // takes head-dim lanes [dc * 8, +8) of the rows grp, grp + kGroups, ...
  constexpr int kDC = HD / 8;             // 8-lane slices a row
  constexpr int kGroups = kThreads / kDC; // row groups
  const int dc = tid % kDC, grp = tid / kDC;
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
#pragma unroll 4
  for (int r = grp; r < rows; r += kGroups) {
    if (!s_keep[r]) continue;
    float vf[8];
    load8(reinterpret_cast<const T*>(vs + r * L::kRow) + dc * 8, vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pg = s_p[g * kChunk + r];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
    }
  }
  // Row groups of a warp through shuffles, then the warps through shared
  // memory (the K chunk's space), summed in warp order.
#pragma unroll
  for (int o = kDC; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  float* red = reinterpret_cast<float*>(ks);  // [kWarps][G][HD]
  if (lane < kDC)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(warp * G + g) * HD + dc * 8 + e] = acc[g][e];
  __syncthreads();
  float* pa = p.part_acc +
              ((static_cast<long long>(b) * p.Hkv + kvh) * p.nsplit + split) *
                  G * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    float sum = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w * G * HD + i];
    pa[i] = sum;
  }
}

// One block of HD threads per (query head, batch row): the seed's score,
// then the merge of the chunks below write_pos with the seed, in chunk
// order, then out = acc / l. The chunks' (m, l) are staged in shared memory
// (nsplit * 2 floats, dynamic) so that each thread's merge reads them
// without a round trip to device memory; the acc loads are independent and
// unrolled, so they are in flight together.
template <int HD, int G>
__global__ void __launch_bounds__(HD) decode_combine_kernel(DecodeParams p) {
  extern __shared__ float ml_s[];  // [n_used][2]
  __shared__ float red[HD / 32];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = h / G, g = h - kvh * G;
  const int warp = d / 32, lane = d % 32;
  const int n_used = (p.write_pos + kChunk - 1) / kChunk;
  const long long base = (static_cast<long long>(b) * p.Hkv + kvh) * p.nsplit;
  for (int i = d; i < n_used; i += HD) {
    const float* ml = p.part_ml + ((base + i) * G + g) * 2;
    ml_s[2 * i] = ml[0];
    ml_s[2 * i + 1] = ml[1];
  }
  const long long nrow = (static_cast<long long>(b) * p.Hkv + kvh) * HD + d;
  float prod = __bfloat162float(
                   p.q[(static_cast<long long>(b) * p.H + h) * HD + d]) *
               __bfloat162float(p.k_new[nrow]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    prod += __shfl_xor_sync(0xffffffffu, prod, o);
  if (lane == 0) red[warp] = prod;
  __syncthreads();
  float s_new = 0.f;
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) s_new += red[w];
  s_new *= p.scale;

  float m = s_new;
  for (int i = 0; i < n_used; ++i) m = fmaxf(m, ml_s[2 * i]);
  const float w_new = expf(s_new - m);
  float l = w_new, acc = w_new * __bfloat162float(p.v_new[nrow]);
  const float* pa = p.part_acc + (base * G + g) * HD + d;
#pragma unroll 4
  for (int i = 0; i < n_used; ++i) {
    const float w = expf(ml_s[2 * i] - m);  // 0 for a chunk with no kept row
    l = fmaf(w, ml_s[2 * i + 1], l);
    acc = fmaf(w, pa[static_cast<long long>(i) * G * HD], acc);
  }
  p.out[(static_cast<long long>(b) * p.H + h) * HD + d] =
      __float2bfloat16(acc / l);
}

template <int HD, int G, typename T>
cudaError_t launch_split(const DecodeParams& p, cudaStream_t st) {
  auto kernel = decode_chunk_kernel<HD, G, T>;
  constexpr int bytes = Smem<HD, G, T>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nsplit, p.Hkv, p.B), kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int HD, int G>
cudaError_t launch(const DecodeParams& p, bool int8, cudaStream_t st) {
  const cudaError_t err = int8 ? launch_split<HD, G, int8_t>(p, st)
                               : launch_split<HD, G, __nv_bfloat16>(p, st);
  if (err != cudaSuccess) return err;
  decode_combine_kernel<HD, G><<<dim3(p.H, p.B), HD,
                                  p.nsplit * 2 * sizeof(float), st>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const DecodeParams& p, int G, bool int8,
                      cudaStream_t st) {
  switch (G) {
    case 1: return launch<HD, 1>(p, int8, st);
    case 2: return launch<HD, 2>(p, int8, st);
    case 4: return launch<HD, 4>(p, int8, st);
    case 7: return launch<HD, 7>(p, int8, st);  // Qwen2-7B: 28 on 4
    case 8: return launch<HD, 8>(p, int8, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Pointers are device
// pointers to contiguous tensors; cache_k/cache_v/k_scale/v_scale are the
// stacked [L, ...] tensors (k_scale/v_scale null for a bf16 cache), offset
// here to `layer`; part_acc/part_ml are fp32 scratch of
// B * Hkv * nsplit * G * hd and B * Hkv * nsplit * G * 2 floats, with
// nsplit = ceil(M / 128). window < 0 means none.
extern "C" int vl2_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* cache_k,
    const void* cache_v, const void* k_scale, const void* v_scale,
    const void* valid_len, void* out, void* part_acc, void* part_ml, int B,
    int H, int Hkv, int D, int M, int layer, int write_pos, int prompt_len,
    int window, int nsplit, float scale, void* stream) {
  const bool int8 = k_scale != nullptr;
  const long long layer_elems = static_cast<long long>(layer) * B * M * Hkv * D;
  const long long elem = int8 ? 1 : 2;
  if (nsplit != (M + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (D == 128) return static_cast<int>(launch_hd<128>(p, G, int8, st));
  if (D == 64) return static_cast<int>(launch_hd<64>(p, G, int8, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
