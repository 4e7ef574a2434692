// K6's kernel (decode_matmul_q4.cu): the layered folded-int4 weight-only
// matmul y[R, Dout] = (x[R, Din] @ bf16(W)) * scale in fp32, cast to bf16.
// K4, K5 and K7 run on the split-K core (splitk_matmul.cuh).
//
// A block owns 32 output columns (4 warps, one n8 column tile each) over the
// whole reduction depth, in chunks of 256 weight rows. Each chunk's weights
// are loaded 16 bytes a thread, converted to bf16 in registers (exact) into a
// padded shared tile and multiplied with mma.sync m16n8k16 (bf16 in, fp32
// out) read through ldmatrix; R = 16 is exactly its M, larger R (up to 64)
// loops over 16-row tiles that share each weight tile. The next chunk's
// weights and activations are loaded into registers while the tensor cores
// consume the current one, so no cross-block reduction is needed.
//
// Folded int4 (ops/quant.quantize_int4): the layer is [Din/2, Dout] bytes,
// byte row i holding weight row i in its low nibble (stored offset-binary,
// lo + 8) and weight row i + Din/2 in its high nibble (two's complement). A
// chunk is packed rows [k0, k0 + 128): one 16-byte load gives 16 columns of
// two weight rows; the low nibbles fill shared rows [0, 128) and the high
// nibbles rows [128, 256), and the activation tile pairs them with
// x[:, k0 : k0 + 128] and x[:, Din/2 + k0 : Din/2 + k0 + 128]. Sign
// extension is integer work: hi = (int8)b >> 4 (arithmetic), lo = (b & 0xF)
// - 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"  // ldsm_x4, ldsm_x4_trans, mma_bf16, pack_bf16

namespace vl2_mm {

constexpr int kThreads = 128;    // 4 warps, one n8 column tile each
constexpr int kBN = 32;          // output columns a block
constexpr int kBK = 256;         // reduction rows (weight rows) a chunk
constexpr int kPRows = kBK / 2;  // packed (byte) rows a chunk
constexpr int kWRow = kBN + 8;   // bf16 row stride of the weight tile (80 B)
constexpr int kXRow = kBK + 8;   // bf16 row stride of the activation tile

struct MatParams {
  const __nv_bfloat16* x;  // [R, Din] contiguous
  const int8_t* w;         // layer base, [Din/2, Dout] folded int4
  const void* s;           // layer base, [Dout] scales (bf16 or fp32)
  __nv_bfloat16* y;        // [R, Dout]
  int R, Din, Dout;        // Din: the reduction depth in weights (unpacked)
};

template <bool kF32>
__device__ __forceinline__ float load_scale(const void* s, int n) {
  if constexpr (kF32)
    return static_cast<const float*>(s)[n];
  else
    return __bfloat162float(static_cast<const __nv_bfloat16*>(s)[n]);
}

// 16 folded int4 bytes -> the 16 low-nibble weights (rows i) and the 16
// high-nibble weights (rows i + Din/2), each as two 16-byte rows of 8 bf16.
__device__ __forceinline__ void int4x16_to_bf16(const int4 v, uint4 (&lo)[2],
                                                uint4 (&hi)[2]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  uint32_t l[8], h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int word = w[i / 2];
    const int sh = 16 * (i % 2);
    const int a = static_cast<int8_t>(word >> sh);        // sign-extended
    const int b = static_cast<int8_t>(word >> (sh + 8));
    l[i] = vl2::pack_bf16(static_cast<float>((a & 0xF) - 8),
                          static_cast<float>((b & 0xF) - 8));
    h[i] = vl2::pack_bf16(static_cast<float>(a >> 4),
                          static_cast<float>(b >> 4));
  }
  lo[0] = make_uint4(l[0], l[1], l[2], l[3]);
  lo[1] = make_uint4(l[4], l[5], l[6], l[7]);
  hi[0] = make_uint4(h[0], h[1], h[2], h[3]);
  hi[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// RT 16-row tiles of x; kF32: fp32 scales (else bf16).
template <int RT, bool kF32>
__global__ void __launch_bounds__(kThreads) matmul_kernel(MatParams p) {
  constexpr int kWLoads = kPRows * kBN / 16 / kThreads;  // 16-byte loads
  constexpr int kXLoads = RT * 16 * (kBK / 8) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBK][kWRow]
  __nv_bfloat16* xs = ws + kBK * kWRow;  // [RT*16][kXRow]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const int nchunks = p.Din / kBK;

  int4 wreg[kWLoads];
  uint4 xreg[kXLoads];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / 2, half = idx % 2;
      wreg[i] = *reinterpret_cast<const int4*>(
          p.w + static_cast<long long>(c * kPRows + row) * p.Dout + n0 +
          half * 16);
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / 8), cc = idx % (kBK / 8);
      // the tile's first half reads x[:, k0 + ...], its second half
      // x[:, Din/2 + k0 + ...], the rows the high nibbles hold
      const int col = cc < kBK / 16
                          ? c * kPRows + cc * 8
                          : p.Din / 2 + c * kPRows + (cc - kBK / 16) * 8;
      xreg[i] = r < p.R ? *reinterpret_cast<const uint4*>(
                              p.x + static_cast<long long>(r) * p.Din + col)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
    acc[rt][0] = acc[rt][1] = acc[rt][2] = acc[rt][3] = 0.f;

  load_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every warp is done with the previous chunk's tiles
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / 2, half = idx % 2;
      uint4* dst = reinterpret_cast<uint4*>(ws + row * kWRow + half * 16);
      uint4 lo[2], hi[2];
      int4x16_to_bf16(wreg[i], lo, hi);
      uint4* dhi = dst + kPRows * kWRow / 8;  // row + 128
      dst[0] = lo[0];
      dst[1] = lo[1];
      dhi[0] = hi[0];
      dhi[1] = hi[1];
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / 8), cc = idx % (kBK / 8);
      *reinterpret_cast<uint4*>(xs + r * kXRow + cc * 8) = xreg[i];
    }
    __syncthreads();
    if (c + 1 < nchunks) load_chunk(c + 1);  // in flight during the products

#pragma unroll 2
    for (int kc = 0; kc < kBK / 16; kc += 2) {
      // B fragments of two k16 steps for this warp's 8 columns
      uint32_t b[4];
      vl2::ldsm_x4_trans(b[0], b[1], b[2], b[3],
                         ws + (kc * 16 + lane) * kWRow + warp * 8);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        uint32_t a0[4], a1[4];
        const __nv_bfloat16* xa =
            xs + (rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXRow +
            kc * 16 + (lane >> 4) * 8;
        vl2::ldsm_x4(a0[0], a0[1], a0[2], a0[3], xa);
        vl2::ldsm_x4(a1[0], a1[1], a1[2], a1[3], xa + 16);
        vl2::mma_bf16(acc[rt], a0, b[0], b[1]);
        vl2::mma_bf16(acc[rt], a1, b[2], b[3]);
      }
    }
  }

  // Epilogue: this thread holds rows (g, g + 8) of each row tile at columns
  // n, n + 1.
  const int g = lane >> 2, t = lane & 3;
  const int n = n0 + warp * 8 + 2 * t;
  float s[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j] = load_scale<kF32>(p.s, n + j);
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rt * 16 + g + half * 8;
      if (row >= p.R) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          p.y + static_cast<long long>(row) * p.Dout + n) =
          __floats2bfloat162_rn(acc[rt][half * 2] * s[0],
                                acc[rt][half * 2 + 1] * s[1]);
    }
}

template <int RT, bool kF32>
int launch(const MatParams& p, cudaStream_t st) {
  constexpr int kSmem = (kBK * kWRow + RT * 16 * kXRow) *
                        static_cast<int>(sizeof(__nv_bfloat16));
  static bool configured = false;  // the opt-in above 48 KB, once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel<RT, kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  matmul_kernel<RT, kF32><<<p.Dout / kBN, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF32>
int launch_rows(const MatParams& p, cudaStream_t st) {
  switch ((p.R + 15) / 16) {
    case 1: return launch<1, kF32>(p, st);
    case 2: return launch<2, kF32>(p, st);
    case 3: return launch<3, kF32>(p, st);
    case 4: return launch<4, kF32>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns the cudaError_t of the launch; refuses shapes the kernel does not
// tile (1 <= R <= 64, Din % 256 == 0, Dout % 32 == 0).
inline int dispatch(const MatParams& p, int scale_f32, cudaStream_t st) {
  if (p.R < 1 || p.Din % kBK || p.Dout % kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  return scale_f32 ? launch_rows<true>(p, st) : launch_rows<false>(p, st);
}

// The MatParams of one call: x [R, Din], w/s layer bases, y [R, Dout].
inline MatParams make_params(const void* x, const void* w, const void* s,
                             void* y, int R, int Din, int Dout) {
  MatParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.s = s;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.R = R; p.Din = Din; p.Dout = Dout;
  return p;
}

}  // namespace vl2_mm
