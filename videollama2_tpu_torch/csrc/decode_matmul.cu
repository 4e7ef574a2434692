// K4 and K5: layered int8 weight-only matmuls of the decode step.
//
// K4 replaces videollama2_tpu/ops/decode_matmul.py::matmul_q8_layered
// (Pallas `_mm_kernel`): y[R, Dout] = (x[R, Din] @ bf16(q[li])) with fp32
// accumulation, times fp32(scale[li]), cast to bf16. K5 replaces
// ffn_q8_layered (`_ffn_kernel`): g = (x @ G) * gs and u = (x @ U) * us in
// fp32, h = silu(g) * u rounded to bf16, out = (h @ D) * ds cast to bf16.
// The layer's weights are read in place from the stacked [L, Din, Dout]
// int8 packs (the wrapper passes layer li's base pointers).
//
// What bounds them on the H100: bandwidth. At decode (R = 16 rows) a layer
// streams 25 MB (qkv), 17 MB (o) and 176 MB (FFN) of int8 weights for ~2
// FLOPs a byte per row; the tensor cores idle. The design reads every
// weight byte once, 16 bytes a thread, converts int8 to bf16 in registers
// (exact) into a padded shared tile, and multiplies with mma.sync m16n8k16
// (bf16 in, fp32 out): R = 16 is exactly its M, larger R (up to 64) loops
// over 16-row tiles that share each weight tile. A block owns 32 output
// columns (4 warps, one n8 tile each) over the whole reduction depth, in
// chunks of 256 rows, and loads the next chunk's weights and activations
// into registers while the tensor cores consume the current one, so no
// cross-block reduction is needed. K5 is two launches: gate and up share
// one pass whose epilogue writes h [R, F] in bf16 (the rounding the Pallas
// kernel applies), then the down product is K4's kernel over h.
//
// Known limit (later work): 32 columns a block gives 128 blocks for a
// 4096-column output (o, down) on 132 SMs, one block each, with a single
// chunk in flight per block; split-K, TMA and wgmma would fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"  // ldsm_x4, ldsm_x4_trans, mma_bf16

namespace {

constexpr int kThreads = 128;    // 4 warps, one n8 column tile each
constexpr int kBN = 32;          // output columns a block
constexpr int kBK = 256;         // reduction rows a chunk
constexpr int kWRow = kBN + 8;   // bf16 row stride of the weight tile (80 B)
constexpr int kXRow = kBK + 8;   // bf16 row stride of the activation tile
constexpr int kWLoads = kBK * kBN / 16 / kThreads;  // 16-byte weight loads

struct MatParams {
  const __nv_bfloat16* x;  // [R, Din] contiguous
  const int8_t* w0;        // layer base, [Din, Dout] (the gate for SwiGLU)
  const void* s0;          // layer base, [Dout] scales (bf16 or fp32)
  const int8_t* w1;        // SwiGLU only: the up weight
  const void* s1;
  __nv_bfloat16* y;        // [R, Dout]
  int R, Din, Dout;
};

template <bool kF32>
__device__ __forceinline__ float load_scale(const void* s, int n) {
  if constexpr (kF32)
    return static_cast<const float*>(s)[n];
  else
    return __bfloat162float(static_cast<const __nv_bfloat16*>(s)[n]);
}

// 16 int8 values -> two 16-byte rows of 8 bf16.
__device__ __forceinline__ void int8x16_to_bf16(const int4 v, uint4& lo,
                                                uint4& hi) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int word = w[i / 2];
    const int sh = 16 * (i % 2);
    const float a = static_cast<float>(static_cast<int8_t>(word >> sh));
    const float b = static_cast<float>(static_cast<int8_t>(word >> (sh + 8)));
    out[i] = vl2::pack_bf16(a, b);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// RT 16-row tiles of x; kSwiGLU: two weights (gate, up) and the SwiGLU
// epilogue; kF32: fp32 scales (else bf16).
template <int RT, bool kSwiGLU, bool kF32>
__global__ void __launch_bounds__(kThreads) q8_matmul_kernel(MatParams p) {
  constexpr int kNW = kSwiGLU ? 2 : 1;
  constexpr int kXLoads = RT * 16 * (kBK / 8) / kThreads;  // 16-byte pieces
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [kNW][kBK][kWRow]
  __nv_bfloat16* xs = ws + kNW * kBK * kWRow;                   // [RT*16][kXRow]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const int nchunks = p.Din / kBK;
  const int8_t* wsrc[2] = {p.w0, p.w1};

  int4 wreg[kNW][kWLoads];
  uint4 xreg[kXLoads];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int row = idx / 2, half = idx % 2;
        wreg[w][i] = *reinterpret_cast<const int4*>(
            wsrc[w] + static_cast<long long>(c * kBK + row) * p.Dout + n0 +
            half * 16);
      }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / 8), cc = idx % (kBK / 8);
      xreg[i] = r < p.R ? *reinterpret_cast<const uint4*>(
                              p.x + static_cast<long long>(r) * p.Din +
                              c * kBK + cc * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[kNW][RT][4];
#pragma unroll
  for (int w = 0; w < kNW; ++w)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
      acc[w][rt][0] = acc[w][rt][1] = acc[w][rt][2] = acc[w][rt][3] = 0.f;

  load_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every warp is done with the previous chunk's tiles
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int row = idx / 2, half = idx % 2;
        uint4 lo, hi;
        int8x16_to_bf16(wreg[w][i], lo, hi);
        uint4* dst = reinterpret_cast<uint4*>(ws + (w * kBK + row) * kWRow +
                                              half * 16);
        dst[0] = lo;
        dst[1] = hi;
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
      uint32_t b[kNW][4];
#pragma unroll
      for (int w = 0; w < kNW; ++w)
        vl2::ldsm_x4_trans(b[w][0], b[w][1], b[w][2], b[w][3],
                           ws + (w * kBK + kc * 16 + lane) * kWRow + warp * 8);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        uint32_t a0[4], a1[4];
        const __nv_bfloat16* xa =
            xs + (rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXRow +
            kc * 16 + (lane >> 4) * 8;
        vl2::ldsm_x4(a0[0], a0[1], a0[2], a0[3], xa);
        vl2::ldsm_x4(a1[0], a1[1], a1[2], a1[3], xa + 16);
#pragma unroll
        for (int w = 0; w < kNW; ++w) {
          vl2::mma_bf16(acc[w][rt], a0, b[w][0], b[w][1]);
          vl2::mma_bf16(acc[w][rt], a1, b[w][2], b[w][3]);
        }
      }
    }
  }

  // Epilogue: this thread holds rows (g, g + 8) of each row tile at columns
  // n, n + 1.
  const int g = lane >> 2, t = lane & 3;
  const int n = n0 + warp * 8 + 2 * t;
  float s0[2], s1[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s0[j] = load_scale<kF32>(p.s0, n + j);
    s1[j] = kSwiGLU ? load_scale<kF32>(p.s1, n + j) : 0.f;
  }
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rt * 16 + g + half * 8;
      if (row >= p.R) continue;
      float o[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float gv = acc[0][rt][half * 2 + j] * s0[j];
        if constexpr (kSwiGLU) {
          const float uv = acc[kNW - 1][rt][half * 2 + j] * s1[j];
          o[j] = gv / (1.f + expf(-gv)) * uv;  // silu(g) * u
        } else {
          o[j] = gv;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(
          p.y + static_cast<long long>(row) * p.Dout + n) =
          __floats2bfloat162_rn(o[0], o[1]);
    }
}

template <int RT, bool kSwiGLU, bool kF32>
int launch(const MatParams& p, cudaStream_t st) {
  constexpr int kNW = kSwiGLU ? 2 : 1;
  constexpr int kSmem =
      (kNW * kBK * kWRow + RT * 16 * kXRow) * static_cast<int>(sizeof(__nv_bfloat16));
  static bool configured = false;  // the opt-in above 48 KB, once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        q8_matmul_kernel<RT, kSwiGLU, kF32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  q8_matmul_kernel<RT, kSwiGLU, kF32>
      <<<p.Dout / kBN, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSwiGLU, bool kF32>
int launch_rows(const MatParams& p, cudaStream_t st) {
  switch ((p.R + 15) / 16) {
    case 1: return launch<1, kSwiGLU, kF32>(p, st);
    case 2: return launch<2, kSwiGLU, kF32>(p, st);
    case 3: return launch<3, kSwiGLU, kF32>(p, st);
    case 4: return launch<4, kSwiGLU, kF32>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const MatParams& p, bool swiglu, int scale_f32,
             cudaStream_t st) {
  if (p.R < 1 || p.Din % kBK || p.Dout % kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (swiglu)
    return scale_f32 ? launch_rows<true, true>(p, st)
                     : launch_rows<true, false>(p, st);
  return scale_f32 ? launch_rows<false, true>(p, st)
                   : launch_rows<false, false>(p, st);
}

}  // namespace

// K4 (and K5's down pass). Returns the cudaError_t of the launch. x [R, Din]
// bf16, w layer li's [Din, Dout] int8, s layer li's [Dout] scales (fp32 when
// scale_f32, else bf16), y [R, Dout] bf16; all contiguous device memory,
// 1 <= R <= 64, Din % 256 == 0, Dout % 32 == 0.
extern "C" int vl2_matmul_q8(const void* x, const void* w, const void* s,
                             void* y, int R, int Din, int Dout, int scale_f32,
                             void* stream) {
  MatParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w0 = static_cast<const int8_t*>(w);
  p.s0 = s;
  p.w1 = nullptr;
  p.s1 = nullptr;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.R = R; p.Din = Din; p.Dout = Dout;
  return dispatch(p, false, scale_f32, static_cast<cudaStream_t>(stream));
}

// K5's first pass: h [R, F] = bf16(silu((x @ G) * gs) * ((x @ U) * us)),
// with G/U layer li's [D, F] int8 and gs/us their [F] scales.
extern "C" int vl2_ffn_q8_gate_up(const void* x, const void* g,
                                  const void* gs, const void* u,
                                  const void* us, void* h, int R, int D,
                                  int F, int scale_f32, void* stream) {
  MatParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w0 = static_cast<const int8_t*>(g);
  p.s0 = gs;
  p.w1 = static_cast<const int8_t*>(u);
  p.s1 = us;
  p.y = static_cast<__nv_bfloat16*>(h);
  p.R = R; p.Din = D; p.Dout = F;
  return dispatch(p, true, scale_f32, static_cast<cudaStream_t>(stream));
}
