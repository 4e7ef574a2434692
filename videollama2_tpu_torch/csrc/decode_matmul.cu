// K4 and K5: layered int8 weight-only matmuls of the decode step.
//
// K4 replaces videollama2_tpu/ops/decode_matmul.py::matmul_q8_layered
// (Pallas `_mm_kernel`): y[R, Dout] = (x[R, Din] @ bf16(q[li])) with fp32
// accumulation, times fp32(scale[li]), cast to bf16. K5 replaces
// ffn_q8_layered (`_ffn_kernel`): g = (x @ G) * gs and u = (x @ U) * us in
// fp32, h = silu(g) * u rounded to bf16, out = (h @ D) * ds cast to bf16.
// The layer's weights are read in place from the stacked [L, Din, Dout]
// int8 packs (the wrapper passes layer li's base pointers). The entry
// vl2_matmul_q8 takes any one [Din, Dout] int8 matrix with its [Dout]
// scales, so it also serves ops/quant_matmul.matmul_q8 (the non-layered
// videollama2_tpu/ops/quant_matmul.py::matmul_q8).
//
// What bounds them on the H100: bandwidth. At decode (R = 16 rows) a layer
// streams 25 MB (qkv), 17 MB (o) and 176 MB (FFN) of int8 weights for ~2
// FLOPs a byte per row; the tensor cores idle. The design (decode_matmul.cuh)
// reads every weight byte once, 16 bytes a thread, converts int8 to bf16 in
// registers (exact) into a padded shared tile, and multiplies with mma.sync
// m16n8k16 (bf16 in, fp32 out). K5 is two launches: gate and up share one
// pass whose epilogue writes h [R, F] in bf16 (the rounding the Pallas
// kernel applies), then the down product is K4's kernel over h.
//
// Known limit (later work): 32 columns a block gives 128 blocks for a
// 4096-column output (o, down) on 132 SMs, one block each, with a single
// chunk in flight per block; split-K, TMA and wgmma would fill the card.

#include "decode_matmul.cuh"

// K4 (and K5's down pass). Returns the cudaError_t of the launch. x [R, Din]
// bf16, w layer li's [Din, Dout] int8, s layer li's [Dout] scales (fp32 when
// scale_f32, else bf16), y [R, Dout] bf16; all contiguous device memory,
// 1 <= R <= 64, Din % 256 == 0, Dout % 32 == 0.
extern "C" int vl2_matmul_q8(const void* x, const void* w, const void* s,
                             void* y, int R, int Din, int Dout, int scale_f32,
                             void* stream) {
  return vl2_mm::dispatch<false>(
      vl2_mm::make_params(x, w, s, nullptr, nullptr, y, R, Din, Dout), false,
      scale_f32, static_cast<cudaStream_t>(stream));
}

// K5's first pass: h [R, F] = bf16(silu((x @ G) * gs) * ((x @ U) * us)),
// with G/U layer li's [D, F] int8 and gs/us their [F] scales.
extern "C" int vl2_ffn_q8_gate_up(const void* x, const void* g,
                                  const void* gs, const void* u,
                                  const void* us, void* h, int R, int D,
                                  int F, int scale_f32, void* stream) {
  return vl2_mm::dispatch<false>(
      vl2_mm::make_params(x, g, gs, u, us, h, R, D, F), true, scale_f32,
      static_cast<cudaStream_t>(stream));
}
