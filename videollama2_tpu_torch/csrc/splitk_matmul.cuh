// Split-K core of the weight-only decode matmuls: y[R, Dout] = (x[R, Din] @
// bf16(W)) * scale in fp32, cast to bf16, optionally with two weights (gate,
// up) and the SwiGLU epilogue, over int8 packs or folded int4 packs. K4,
// matmul_q8 and K5 (decode_matmul.cu) and K6 and K7 (decode_matmul_q4.cu)
// run on it.
//
// Made for a weight stream at the card's memory rate (decode: R = 16 rows,
// ~2 FLOPs a weight a row):
//
// - Wide tiles. A block owns 128 output columns, so every packed weight row
//   it reads is one 128-byte line, over a range of the reduction depth.
// - Split-K. The reduction depth is cut into chunks of 256 weight rows
//   (256 int8 rows, or 128 folded int4 byte rows), and each column tile's
//   chunks into `splits` (at most 8) contiguous ranges (uneven by at most
//   one chunk), one block each, so that tiles x splits blocks come near a
//   target of blocks an SM whatever the width (more splits add partial
//   sums to reduce). The split count comes from
//   ops/decode_matmul.split_plan.
// - A ring of kStages raw stages (64 packed rows x 128 columns of bytes a
//   weight, plus the x slice they multiply) in dynamic shared memory,
//   filled with 16-byte cp.async copies; a block keeps kStages - 1 stages
//   in flight (32 KB with gate and up: 64 KB an SM at two blocks). A stage
//   holds the same bytes whether they are int8 or int4: 64 or 128 weight
//   rows.
// - int8 -> bf16 without I2F: the byte, its sign bit flipped, is put by a
//   prmt into the mantissa of the float 2^23 (0x4B0000uu = 2^23 + b + 128),
//   one FADD of -(2^23 + 128) leaves b exactly, and a prmt takes the upper
//   halves of two such floats as one bf16x2 (exact for [-128, 127]).
// - Folded int4 (ops/quant.quantize_int4): byte row i of a pack holds
//   weight row i in its low nibble (offset-binary, n + 8) and weight row
//   i + Din/2 in its high nibble (two's complement). A stage of 64 byte rows
//   carries 128 weight rows, and its x slice holds the two pieces they
//   multiply: x[:, k0 : k0 + 64] for the low nibbles and x[:, Din/2 + k0 :
//   Din/2 + k0 + 64] for the high ones, so a down pass over h folded over F
//   pairs h's columns f and f + F/2 by itself. int4 -> bf16 is integer
//   work: a prmt puts byte j of two rows' words at bytes 0 and 2, a lop3
//   masks a nibble into the mantissa of the bf16 128.0 (0x4300) and flips
//   the high nibble's sign bit, giving 128 + n + 8 exactly in both halves,
//   and one bf16x2 FMA subtracts 136: about 1.5 instructions a weight, none
//   of them I2F.
// - The conversion happens on the way from shared memory to the mma.sync
//   fragments. A thread reads one 32-bit word (4 columns) from each of 4
//   consecutive packed rows: the mma's k index 2t, 2t + 1, 2t + 8, 2t + 9
//   is mapped to rows 4t .. 4t + 3 (x's fragment follows the same map: one
//   8-byte read a row; for int4 once in each piece), and n-tile j's column
//   g to column 4g + j, so the 4 words give the B fragments of 4 n-tiles
//   (twice over for int4: the low and the high nibbles), and a thread's
//   accumulators hold 8 consecutive output columns. The 16-byte chunks of a
//   stage row are XOR-swizzled by (row / 4) % 4 so that those reads are
//   free of bank conflicts.
// - Fixed-order reduction inside the launch, through distributed shared
//   memory: a column tile's splits are one thread-block cluster (Hopper
//   schedules its blocks together on one GPC). Each block puts its fp32
//   partial sums into its own shared memory, the cluster synchronizes, and
//   each block sums a 1/splits share of the tile's outputs over all the
//   blocks' partials in split order, applies the scales (and SwiGLU, h
//   rounded to bf16) and writes them. No partial sum goes through device
//   memory, and there is no atomic and no fence. Two runs are bit-equal.
//   With one split (the LM head's widths) a block writes its output from
//   its registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attention_tile.cuh"  // mma_bf16, pack_bf16
#include "cp_async.cuh"

namespace vl2_sk {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps, 32 output columns each
constexpr int kBN = 128;       // output columns a block: one 128-byte row
constexpr int kChunk = 256;    // weight rows a plan chunk
constexpr int kSR = 64;        // packed rows a ring stage
constexpr int kMaxSplits = 8;  // a tile's splits are one (portable) cluster
constexpr int kPartRow = kBN + 4;  // float row stride of the partial sums

// Packed rows a plan chunk: 256 int8 rows, or 128 folded int4 byte rows.
template <bool kQ4>
__host__ __device__ constexpr int chunk_rows() {
  return kQ4 ? kChunk / 2 : kChunk;
}

struct Params {
  const bf16* x;         // [R, Din] contiguous
  const int8_t* w[2];    // layer bases, [Din, Dout] int8 or [Din/2, Dout] int4
  const void* s[2];      // layer bases, [Dout] scales (bf16 or fp32)
  bf16* y;               // [R, Dout]
  int R, Din, Dout;      // Din: the reduction depth in weights
  int splits;            // 1 .. kMaxSplits ranges of each tile's chunks
};

// Stages of the ring: three with two weights, four with one (about 57 and
// 42 KB at R <= 16 for int8).
template <int kNW>
__host__ __device__ constexpr int stages() { return kNW == 2 ? 3 : 4; }

template <int kNW, int RT, bool kQ4>
struct Smem {
  static constexpr int kW = kSR * kBN;                     // weight bytes
  static constexpr int kXCols = kQ4 ? 2 * kSR : kSR;       // x columns
  // bf16 row stride of the x slice (160 or 288 B: conflict-free 8-byte
  // reads)
  static constexpr int kXRow = kXCols + 16;
  static constexpr int kX = RT * 16 * kXRow * 2;           // bf16 bytes
  static constexpr int kStage = kNW * kW + kX;
  static constexpr int kBytes = stages<kNW>() * kStage;
  // the partial sums of RT * 16 rows fit where the ring was
  static_assert(kNW * RT * 16 * kPartRow * 4 <= kBytes, "partials");
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

// bf16x2 of the two halves 128 + m (m in [0, 15]), minus 136: m - 8 exactly.
__device__ __forceinline__ uint32_t minus_136(uint32_t v) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// Folded int4: byte j of a and of b (two consecutive packed rows) -> the
// bf16x2 of their low nibbles' weights and that of their high nibbles'
// (a's in the low half). The low nibble holds n + 8; the high nibble holds
// n in two's complement, and flipping its top bit makes it n + 8 too.
__device__ __forceinline__ void int4_to_bf16x2(uint32_t a, uint32_t b, int j,
                                               uint32_t& lo, uint32_t& hi) {
  const uint32_t d = prmt(a, b, 0x4400u + 0x1111u * j);  // bytes 0, 2
  lo = minus_136((d & 0x000F000Fu) | 0x43004300u);
  hi = minus_136(((d >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

// The shared-memory offset of byte `col` of stage row `row`: 16-byte chunk
// c of a row is stored at chunk c ^ (2 * ((row / 4) % 4)).
__device__ __forceinline__ int swz(int row, int col) {
  return row * kBN + ((((col >> 4) ^ (((row >> 2) & 3) << 1))) << 4) +
         (col & 15);
}

// Output column n's value from its fp32 sums g (and u) and the scales gs
// (and us): one weight, g times the scale; two, silu(g * gs) * (u * us).
template <int kNW, bool kF32>
__device__ __forceinline__ float finish(const void* gs, const void* us,
                                        float g, float u, int n) {
  const float gv = g * load_scale<kF32>(gs, n);
  if constexpr (kNW == 2) {
    const float uv = u * load_scale<kF32>(us, n);
    return gv / (1.f + expf(-gv)) * uv;  // silu(g) * u
  } else {
    return gv;
  }
}

// One block: column tile blockIdx.y, split blockIdx.x (of the tile's C
// chunks, [C * split / splits, C * (split + 1) / splits): ranges that
// differ by at most one chunk, ops/decode_matmul.split_plan's bounds).
// kNW: one weight, or gate and up with the SwiGLU epilogue; RT: 16-row
// tiles of x; kF32: fp32 scales; kQ4: folded int4 weights.
template <int kNW, int RT, bool kF32, bool kQ4>
__global__ void __launch_bounds__(kThreads)
    splitk_kernel(Params p) {
  using L = Smem<kNW, RT, kQ4>;
  constexpr int kStages = stages<kNW>();
  constexpr int kPieceLoads = kSR / 8;  // 16-byte copies a row of a piece
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, tile = blockIdx.y;
  const int n0 = tile * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = p.Din / kChunk;
  const int c_begin = chunks * split / p.splits;
  const int c_end = chunks * (split + 1) / p.splits;
  const int k_begin = c_begin * chunk_rows<kQ4>();  // packed row
  const int n_stages = (c_end - c_begin) * (chunk_rows<kQ4>() / kSR);

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
    // x's slice: one piece of kSR columns from column k0, and for int4 a
    // second from column Din/2 + k0 (the rows the high nibbles hold)
    bf16* xs = reinterpret_cast<bf16*>(st + kNW * L::kW);
#pragma unroll
    for (int i = 0; i < RT * 16 * (L::kXCols / 8) / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (L::kXCols / 8), c = idx % (L::kXCols / 8);
      const int piece = c / kPieceLoads;
      const bool ok = r < p.R;
      vl2::cp_async16(xs + r * L::kXRow + c * 8,
                      ok ? p.x + static_cast<long long>(r) * p.Din +
                               piece * (p.Din / 2) + k0 +
                               (c % kPieceLoads) * 8
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

  // acc += x's piece (columns from `col`) times the B fragments b
  auto products = [&](const bf16* xs, int col,
                      const uint32_t (&b)[kNW][4][2]) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      // A fragment: x rows g and g + 8, columns col + 4t .. + 3
      const uint2 lo = *reinterpret_cast<const uint2*>(
          xs + (rt * 16 + g) * L::kXRow + col + 4 * t);
      const uint2 hi = *reinterpret_cast<const uint2*>(
          xs + (rt * 16 + g + 8) * L::kXRow + col + 4 * t);
      const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int w = 0; w < kNW; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          vl2::mma_bf16(acc[w][rt][j], a, b[w][j][0], b[w][j][1]);
    }
  };

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
      // the words of packed rows 16s + 4t .. 16s + 4t + 3 at columns
      // warp * 32 + 4g .. + 3: n-tiles j = 0..3 (column 4g + j); int8
      // bytes get their sign bit flipped here
      uint32_t word[kNW][4];
#pragma unroll
      for (int w = 0; w < kNW; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word[w][i] = *reinterpret_cast<const uint32_t*>(
                           st + w * L::kW +
                           swz(16 * s + 4 * t + i, warp * 32 + 4 * g)) ^
                       (kQ4 ? 0u : 0x80808080u);
      uint32_t b[kNW][4][2];
      if constexpr (kQ4) {
        uint32_t bh[kNW][4][2];
#pragma unroll
        for (int w = 0; w < kNW; ++w)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int4_to_bf16x2(word[w][0], word[w][1], j, b[w][j][0],
                           bh[w][j][0]);
            int4_to_bf16x2(word[w][2], word[w][3], j, b[w][j][1],
                           bh[w][j][1]);
          }
        products(xs, 16 * s, b);         // low nibbles: rows k0 + ...
        products(xs, kSR + 16 * s, bh);  // high: rows Din/2 + k0 + ...
      } else {
#pragma unroll
        for (int w = 0; w < kNW; ++w)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float f0 = byte_to_float(word[w][0], j);
            const float f1 = byte_to_float(word[w][1], j);
            const float f2 = byte_to_float(word[w][2], j);
            const float f3 = byte_to_float(word[w][3], j);
            b[w][j][0] = pack_hi(f0, f1);
            b[w][j][1] = pack_hi(f2, f3);
          }
        products(xs, 16 * s, b);
      }
    }
  }
  vl2::cp_async_wait<0>();

  // The thread holds rows g and g + 8 of each row tile at columns
  // warp * 32 + 8t .. + 7 (acc[.][.][j][0..1] at 8t + j and 8t + 4 + j,
  // [2..3] the same for row g + 8).
  if (p.splits == 1) {  // the whole depth: write y from the registers
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rt * 16 + g + half * 8;
        if (row >= p.R) continue;
        const int n = n0 + warp * 32 + 8 * t;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = finish<kNW, kF32>(p.s[0], p.s[1],
                                   acc[0][rt][e % 4][2 * half + e / 4],
                                   acc[kNW - 1][rt][e % 4][2 * half + e / 4],
                                   n + e);
        *reinterpret_cast<uint4*>(p.y + static_cast<long long>(row) * p.Dout +
                                  n) =
            make_uint4(vl2::pack_bf16(o[0], o[1]), vl2::pack_bf16(o[2], o[3]),
                       vl2::pack_bf16(o[4], o[5]), vl2::pack_bf16(o[6], o[7]));
      }
    return;
  }

  // The tile's splits are one thread-block cluster: each block puts its
  // partial sums into its own shared memory (the ring is free now), and
  // block b of the cluster sums, in split order, the float4s q = b * 128 +
  // tid, + splits * 128, ... of every block's partials, read through
  // distributed shared memory, then finishes them into y.
  __syncthreads();  // every warp is done with the ring
  float* part = reinterpret_cast<float*>(smem);  // [kNW][R][kPartRow]
#pragma unroll
  for (int w = 0; w < kNW; ++w)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rt * 16 + g + half * 8;
        if (row >= p.R) continue;
        float4* dst = reinterpret_cast<float4*>(
            part + (w * p.R + row) * kPartRow + warp * 32 + 8 * t);
        dst[0] = make_float4(acc[w][rt][0][2 * half], acc[w][rt][1][2 * half],
                             acc[w][rt][2][2 * half], acc[w][rt][3][2 * half]);
        dst[1] = make_float4(acc[w][rt][0][2 * half + 1],
                             acc[w][rt][1][2 * half + 1],
                             acc[w][rt][2][2 * half + 1],
                             acc[w][rt][3][2 * half + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials are written and visible

  for (int q = split * kThreads + threadIdx.x; q < p.R * (kBN / 4);
       q += p.splits * kThreads) {
    const int row = q / (kBN / 4), col = (q % (kBN / 4)) * 4;
    float4 v[kNW][kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < p.splits) {
        const float* peer = cluster.map_shared_rank(part, sp);
#pragma unroll
        for (int w = 0; w < kNW; ++w)
          v[w][sp] = *reinterpret_cast<const float4*>(
              peer + (w * p.R + row) * kPartRow + col);
      }
    float4 sum[kNW];
#pragma unroll
    for (int w = 0; w < kNW; ++w) sum[w] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)  // fixed order: split 0 first
#pragma unroll
      for (int w = 0; w < kNW; ++w)
        if (sp < p.splits) {
          sum[w].x += v[w][sp].x; sum[w].y += v[w][sp].y;
          sum[w].z += v[w][sp].z; sum[w].w += v[w][sp].w;
        }
    const float s0[4] = {sum[0].x, sum[0].y, sum[0].z, sum[0].w};
    const float s1[4] = {sum[kNW - 1].x, sum[kNW - 1].y, sum[kNW - 1].z,
                         sum[kNW - 1].w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = finish<kNW, kF32>(p.s[0], p.s[1], s0[e], s1[e], n0 + col + e);
    *reinterpret_cast<uint2*>(p.y + static_cast<long long>(row) * p.Dout +
                              n0 + col) =
        make_uint2(vl2::pack_bf16(o[0], o[1]), vl2::pack_bf16(o[2], o[3]));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int kNW, int RT, bool kF32, bool kQ4>
int launch(const Params& p, int tiles, cudaStream_t st) {
  auto kernel = splitk_kernel<kNW, RT, kF32, kQ4>;
  constexpr int kBytes = Smem<kNW, RT, kQ4>::kBytes;
  static bool configured = false;  // the attributes, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    // the whole of the SM's unified memory as shared memory, so that as
    // many blocks as fit share an SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // one cluster a column tile: its splits
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
}

// Returns the cudaError_t of the launch; refuses shapes the kernel does not
// tile (1 <= R <= 64, Din % 256 == 0, Dout % 128 == 0) and split counts
// outside 1 .. min(kMaxSplits, Din / 256).
template <int kNW, bool kQ4>
int dispatch(const Params& p, bool scale_f32, cudaStream_t st) {
  if (p.R < 1 || p.R > 64 || p.Din % kChunk || p.Dout % kBN ||
      p.splits < 1 || p.splits > kMaxSplits || p.splits > p.Din / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = p.Dout / kBN;
  switch ((p.R + 15) / 16) {
    case 1: return scale_f32 ? launch<kNW, 1, true, kQ4>(p, tiles, st)
                             : launch<kNW, 1, false, kQ4>(p, tiles, st);
    case 2: return scale_f32 ? launch<kNW, 2, true, kQ4>(p, tiles, st)
                             : launch<kNW, 2, false, kQ4>(p, tiles, st);
    case 3: return scale_f32 ? launch<kNW, 3, true, kQ4>(p, tiles, st)
                             : launch<kNW, 3, false, kQ4>(p, tiles, st);
    default: return scale_f32 ? launch<kNW, 4, true, kQ4>(p, tiles, st)
                              : launch<kNW, 4, false, kQ4>(p, tiles, st);
  }
}

// One matmul: y [R, Dout] = bf16((x @ W) * s), W [Din, Dout] int8 or
// [Din/2, Dout] folded int4, each column tile's chunks cut into `splits`.
template <bool kQ4>
int matmul(const void* x, const void* w, const void* s, void* y, int R,
           int Din, int Dout, int scale_f32, int splits, cudaStream_t st) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w[0] = p.w[1] = static_cast<const int8_t*>(w);
  p.s[0] = p.s[1] = s;
  p.y = static_cast<bf16*>(y);
  p.R = R; p.Din = Din; p.Dout = Dout; p.splits = splits;
  return dispatch<1, kQ4>(p, scale_f32, st);
}

// The SwiGLU FFN, two launches on one stream: h [R, F] = bf16(silu((x @ G)
// * gs) * ((x @ U) * us)), then out [R, D] = bf16((h @ Dn) * ds), with G/U
// [D, F] and Dn [F, D] (int8, or int4 folded over D and over F), each pass
// with its split count.
template <bool kQ4>
int ffn(const void* x, const void* g, const void* gs, const void* u,
        const void* us, const void* dn, const void* ds, void* h, void* out,
        int R, int D, int F, int scale_f32, int gu_splits, int dn_splits,
        cudaStream_t st) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w[0] = static_cast<const int8_t*>(g);
  p.w[1] = static_cast<const int8_t*>(u);
  p.s[0] = gs;
  p.s[1] = us;
  p.y = static_cast<bf16*>(h);
  p.R = R; p.Din = D; p.Dout = F; p.splits = gu_splits;
  const int err = dispatch<2, kQ4>(p, scale_f32, st);
  if (err != 0) return err;
  return matmul<kQ4>(h, dn, ds, out, R, F, D, scale_f32, dn_splits, st);
}

}  // namespace vl2_sk
