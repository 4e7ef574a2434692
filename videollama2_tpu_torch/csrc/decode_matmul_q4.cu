// K6 and K7: layered folded-int4 weight-only matmuls of the decode step.
//
// K6 replaces videollama2_tpu/ops/decode_matmul.py::matmul_q4_layered
// (Pallas `_mm4_kernel`): y[R, Dout] = (x[:, :Din/2] @ lo(q4[li]) +
// x[:, Din/2:] @ hi(q4[li])) with fp32 accumulation, times fp32(scale[li]),
// cast to bf16; q4 [L, Din/2, Dout] int8 bytes, byte row i holding weight row
// i (low nibble, offset-binary) and row i + Din/2 (high nibble). K7 replaces
// ffn_q4_layered (`_ffn4_kernel`): the SwiGLU FFN over gate/up packs folded
// over D and a down pack folded over F, h rounded to bf16 before the down
// product.
//
// What bounds them on the H100: bandwidth, as for K4/K5, at half the bytes:
// a layer streams 12.6 MB (qkv), 8.4 MB (o) and 88 MB (FFN) of int4 weights
// at R = 16 rows. The design is K4's (decode_matmul.cuh): every weight byte
// is read once, 16 bytes a thread; one load gives 16 columns of the two
// weight rows a byte row folds, which are sign-extended with integer ops and
// converted exactly to bf16 into the two halves of the shared tile, and the
// activation tile pairs them with x's two halves, so the fold needs no
// reordering and the mma.sync loop is K4's. K7 keeps K5's two launches: the
// gate/up pass writes h [R, F] whole in natural column order, and the down
// pass is K6's kernel over h with Din = F, whose fold pairs h columns f and
// f + F/2 by itself (the Pallas kernel pairs them in one grid step only
// because it accumulates the down product across sequential steps).
//
// Known limit (later work): a chunk holds half K4's bytes (8 KB of weights a
// block in flight), so at equal block counts K6 moves half the bytes per
// chunk latency; deeper chunks, split-K, TMA and wgmma would fill the card.

#include "decode_matmul.cuh"

// K6 (and K7's down pass). Returns the cudaError_t of the launch. x [R, Din]
// bf16, w layer li's [Din/2, Dout] folded int4 bytes, s layer li's [Dout]
// scales (fp32 when scale_f32, else bf16), y [R, Dout] bf16; all contiguous
// device memory, 1 <= R <= 64, Din % 256 == 0, Dout % 32 == 0.
extern "C" int vl2_matmul_q4(const void* x, const void* w, const void* s,
                             void* y, int R, int Din, int Dout, int scale_f32,
                             void* stream) {
  return vl2_mm::dispatch<true>(
      vl2_mm::make_params(x, w, s, nullptr, nullptr, y, R, Din, Dout), false,
      scale_f32, static_cast<cudaStream_t>(stream));
}

// K7's first pass: h [R, F] = bf16(silu((x @ G) * gs) * ((x @ U) * us)),
// with G/U layer li's [D/2, F] int4 packs folded over D and gs/us their [F]
// scales.
extern "C" int vl2_ffn_q4_gate_up(const void* x, const void* g,
                                  const void* gs, const void* u,
                                  const void* us, void* h, int R, int D,
                                  int F, int scale_f32, void* stream) {
  return vl2_mm::dispatch<true>(
      vl2_mm::make_params(x, g, gs, u, us, h, R, D, F), true, scale_f32,
      static_cast<cudaStream_t>(stream));
}
