// Split-K core of the int8 weight-only decode matmuls: y[R, Dout] =
// (x[R, Din] @ bf16(W)) * scale in fp32, cast to bf16, optionally with two
// weights (gate, up) and the SwiGLU epilogue. K5 (decode_matmul.cu) runs on
// it; K4, K6 and K7 still run on decode_matmul.cuh.
//
// Made for a weight stream at the card's memory rate (decode: R = 16 rows,
// ~2 FLOPs a weight byte a row):
//
// - Wide tiles. A block owns 128 output columns, so every weight row it
//   reads is one 128-byte line, over a range of the reduction depth.
// - Split-K. The reduction depth is cut into 256-row chunks, and each
//   column tile's chunks into `splits` contiguous ranges (uneven by at most
//   one chunk), one block each, so that tiles x splits blocks come nearest
//   to two an SM whatever the width (more splits add partial sums to write
//   and reduce). The plan (splits and the chunk bounds) comes from
//   ops/decode_matmul.ffn_split_plan.
// - A ring of kStages raw int8 stages (64 weight rows x 128 columns a
//   weight, plus the x slice they multiply) in dynamic shared memory,
//   filled with 16-byte cp.async copies; a block keeps kStages - 1 stages
//   in flight (32 KB with gate and up: 64 KB an SM at two blocks).
// - int8 -> bf16 without I2F: the byte, its sign bit flipped, is put by a
//   prmt into the mantissa of the float 2^23 (0x4B0000uu = 2^23 + b + 128),
//   one FADD of -(2^23 + 128) leaves b exactly, and a prmt takes the upper
//   halves of two such floats as one bf16x2 (exact for [-128, 127]).
// - The conversion happens on the way from shared memory to the mma.sync
//   fragments. A thread reads one 32-bit word (4 columns) from each of 4
//   consecutive weight rows: the mma's k index 2t, 2t + 1, 2t + 8, 2t + 9 is
//   mapped to rows 4t .. 4t + 3 (x's fragment follows the same map: one
//   8-byte read a row), and n-tile j's column g to column 4g + j, so the 4
//   words give the B fragments of 4 n-tiles, and a thread's accumulators
//   hold 8 consecutive output columns. The 16-byte chunks of a stage row
//   are XOR-swizzled by (row / 4) % 4 so that those reads are free of bank
//   conflicts.
// - Fixed-order reduction inside the launch: each block writes its fp32
//   partial sums to a workspace, and the last block of a column tile to
//   arrive (an atomic counter it resets to 0) sums the tile's partials in
//   split order, applies the scales (and SwiGLU, h rounded to bf16) and
//   writes the output. Two runs are bit-equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"  // mma_bf16
#include "cp_async.cuh"

namespace vl2_sk {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps, 32 output columns each
constexpr int kBN = 128;       // output columns a block: one 128-byte row
constexpr int kChunk = 256;    // reduction rows a plan chunk
constexpr int kSR = 64;        // reduction rows a ring stage
constexpr int kXRow = kSR + 16;  // bf16 row stride of a stage's x slice
                                 // (160 B: conflict-free 8-byte reads)

struct Params {
  const bf16* x;         // [R, Din] contiguous
  const int8_t* w[2];    // layer bases, [Din, Dout] int8
  const void* s[2];      // layer bases, [Dout] scales (bf16 or fp32)
  bf16* y;               // [R, Dout]
  float* ws;             // [tiles][splits][weights][R][kBN] partial sums
  int* counters;         // [tiles], 0 between launches
  const int* bounds;     // [splits + 1] chunk bounds of the splits
  int R, Din, Dout, splits;
};

// Stages of the ring: three with two weights, four with one (about 57 and
// 42 KB at R <= 16).
template <int kNW>
__host__ __device__ constexpr int stages() { return kNW == 2 ? 3 : 4; }

template <int kNW, int RT>
struct Smem {
  static constexpr int kW = kSR * kBN;                     // int8 bytes
  static constexpr int kX = RT * 16 * kXRow * 2;           // bf16 bytes
  static constexpr int kStage = kNW * kW + kX;
  static constexpr int kBytes = stages<kNW>() * kStage;
};

template <bool kF32>
__device__ __forceinline__ float load_scale(const void* s, int n) {
  if constexpr (kF32)
    return static_cast<const float*>(s)[n];
  else
    return __bfloat162float(static_cast<const bf16*>(s)[n]);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Byte j of v (already XORed with 0x80 in every byte) as the float
// 2^23 + b + 128, minus 2^23 + 128: b exactly.
__device__ __forceinline__ float byte_to_float(uint32_t v, int j) {
  return __uint_as_float(prmt(v, 0x4B000000u, 0x7540u | j)) - 8388736.f;
}

// Two floats holding small integers -> one bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return prmt(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// The shared-memory offset of byte `col` of stage row `row`: 16-byte chunk
// c of a row is stored at chunk c ^ (2 * ((row / 4) % 4)).
__device__ __forceinline__ int swz(int row, int col) {
  return row * kBN + ((((col >> 4) ^ (((row >> 2) & 3) << 1))) << 4) +
         (col & 15);
}

// One block: column tile blockIdx.y, split blockIdx.x (chunks
// [bounds[split], bounds[split + 1])). kNW: one weight, or gate and up with
// the SwiGLU epilogue; RT: 16-row tiles of x; kF32: fp32 scales.
template <int kNW, int RT, bool kF32>
__global__ void __launch_bounds__(kThreads)
    splitk_kernel(Params p) {
  using L = Smem<kNW, RT>;
  constexpr int kStages = stages<kNW>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, tile = blockIdx.y;
  const int n0 = tile * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k_begin = p.bounds[split] * kChunk;
  const int n_stages = (p.bounds[split + 1] - p.bounds[split]) * (kChunk / kSR);

  auto load_stage = [&](int it) {
    unsigned char* st = smem + (it % kStages) * L::kStage;
    const int k0 = k_begin + it * kSR;
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < kSR * kBN / 16 / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int row = idx / (kBN / 16), c = idx % (kBN / 16);
        vl2::cp_async16(st + w * L::kW + swz(row, c * 16),
                        p.w[w] + static_cast<long long>(k0 + row) * p.Dout +
                            n0 + c * 16,
                        true);
      }
    bf16* xs = reinterpret_cast<bf16*>(st + kNW * L::kW);
#pragma unroll
    for (int i = 0; i < RT * 16 * (kSR / 8) / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kSR / 8), c = idx % (kSR / 8);
      const bool ok = r < p.R;
      vl2::cp_async16(xs + r * kXRow + c * 8,
                      ok ? p.x + static_cast<long long>(r) * p.Din + k0 +
                               c * 8
                         : p.x,
                      ok);
    }
  };

  float acc[kNW][RT][4][4];
#pragma unroll
  for (int w = 0; w < kNW; ++w)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[w][rt][j][0] = acc[w][rt][j][1] = acc[w][rt][j][2] =
            acc[w][rt][j][3] = 0.f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_stages) load_stage(it);
    vl2::cp_async_commit();
  }
  for (int it = 0; it < n_stages; ++it) {
    vl2::cp_async_wait<kStages - 2>();  // this thread's copies of it landed
    __syncthreads();  // everyone's did, and stage it - 1's buffer is free
    if (it + kStages - 1 < n_stages) load_stage(it + kStages - 1);
    vl2::cp_async_commit();
    const int stage = it % kStages;
    const unsigned char* st = smem + stage * L::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(st + kNW * L::kW);
#pragma unroll
    for (int s = 0; s < kSR / 16; ++s) {
      // B fragments of n-tiles j = 0..3 (columns warp * 32 + 4g + j) for
      // the k16 step's rows 16s + 4t .. 16s + 4t + 3
      uint32_t b[kNW][4][2];
#pragma unroll
      for (int w = 0; w < kNW; ++w) {
        uint32_t word[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word[i] = *reinterpret_cast<const uint32_t*>(
                        st + w * L::kW +
                        swz(16 * s + 4 * t + i, warp * 32 + 4 * g)) ^
                    0x80808080u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float f0 = byte_to_float(word[0], j);
          const float f1 = byte_to_float(word[1], j);
          const float f2 = byte_to_float(word[2], j);
          const float f3 = byte_to_float(word[3], j);
          b[w][j][0] = pack_hi(f0, f1);
          b[w][j][1] = pack_hi(f2, f3);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        // A fragment: x rows g and g + 8, columns 16s + 4t .. + 3
        const uint2 lo = *reinterpret_cast<const uint2*>(
            xs + (rt * 16 + g) * kXRow + 16 * s + 4 * t);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            xs + (rt * 16 + g + 8) * kXRow + 16 * s + 4 * t);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int w = 0; w < kNW; ++w)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            vl2::mma_bf16(acc[w][rt][j], a, b[w][j][0], b[w][j][1]);
      }
    }
  }
  vl2::cp_async_wait<0>();

  // This split's partial sums: the thread holds rows g and g + 8 of each
  // row tile at columns warp * 32 + 8t .. + 7 (acc[.][.][j][0..1] at 8t + j
  // and 8t + 4 + j, [2..3] the same for row g + 8).
  const long long tile_ws =
      static_cast<long long>(tile) * p.splits * kNW * p.R * kBN;
  float* part =
      p.ws + tile_ws + static_cast<long long>(split) * kNW * p.R * kBN;
#pragma unroll
  for (int w = 0; w < kNW; ++w)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rt * 16 + g + half * 8;
        if (row >= p.R) continue;
        float4* dst = reinterpret_cast<float4*>(
            part + (w * p.R + row) * kBN + warp * 32 + 8 * t);
        dst[0] = make_float4(acc[w][rt][0][2 * half], acc[w][rt][1][2 * half],
                             acc[w][rt][2][2 * half], acc[w][rt][3][2 * half]);
        dst[1] = make_float4(acc[w][rt][0][2 * half + 1],
                             acc[w][rt][1][2 * half + 1],
                             acc[w][rt][2][2 * half + 1],
                             acc[w][rt][3][2 * half + 1]);
      }

  // The last block of the tile to arrive reduces.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) p.counters[tile] = 0;  // ready for the next launch

  const float* tws = p.ws + tile_ws;
  for (int q = threadIdx.x; q < p.R * (kBN / 4); q += kThreads) {
    const int row = q / (kBN / 4), col = (q % (kBN / 4)) * 4;
    float4 sum[kNW];
#pragma unroll
    for (int w = 0; w < kNW; ++w) {
      sum[w] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < p.splits; ++sp) {  // fixed order: split 0 first
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            tws + (static_cast<long long>(sp) * kNW + w) * p.R * kBN +
            row * kBN + col));
        sum[w].x += v.x; sum[w].y += v.y; sum[w].z += v.z; sum[w].w += v.w;
      }
    }
    const float s0[4] = {sum[0].x, sum[0].y, sum[0].z, sum[0].w};
    const float s1[4] = {sum[kNW - 1].x, sum[kNW - 1].y, sum[kNW - 1].z,
                         sum[kNW - 1].w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + col + e;
      const float gv = s0[e] * load_scale<kF32>(p.s[0], n);
      if constexpr (kNW == 2) {
        const float uv = s1[e] * load_scale<kF32>(p.s[1], n);
        o[e] = gv / (1.f + expf(-gv)) * uv;  // silu(g) * u
      } else {
        o[e] = gv;
      }
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        p.y + static_cast<long long>(row) * p.Dout + n0 + col);
    dst[0] = __floats2bfloat162_rn(o[0], o[1]);
    dst[1] = __floats2bfloat162_rn(o[2], o[3]);
  }
}

template <int kNW, int RT, bool kF32>
int launch(const Params& p, int tiles, cudaStream_t st) {
  auto kernel = splitk_kernel<kNW, RT, kF32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<kNW, RT>::kBytes);
  // the whole of the SM's unified memory as shared memory, so that as many
  // blocks as fit share an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.splits, tiles), kThreads, Smem<kNW, RT>::kBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch; refuses shapes the kernel does not
// tile (1 <= R <= 64, Din % 256 == 0, Dout % 128 == 0).
template <int kNW>
int dispatch(const Params& p, bool scale_f32, cudaStream_t st) {
  if (p.R < 1 || p.R > 64 || p.Din % kChunk || p.Dout % kBN || p.splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = p.Dout / kBN;
  switch ((p.R + 15) / 16) {
    case 1: return scale_f32 ? launch<kNW, 1, true>(p, tiles, st)
                             : launch<kNW, 1, false>(p, tiles, st);
    case 2: return scale_f32 ? launch<kNW, 2, true>(p, tiles, st)
                             : launch<kNW, 2, false>(p, tiles, st);
    case 3: return scale_f32 ? launch<kNW, 3, true>(p, tiles, st)
                             : launch<kNW, 3, false>(p, tiles, st);
    default: return scale_f32 ? launch<kNW, 4, true>(p, tiles, st)
                              : launch<kNW, 4, false>(p, tiles, st);
  }
}

}  // namespace vl2_sk
