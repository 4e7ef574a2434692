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
// at R = 16 rows, and an SM must convert ~28 weights a clock to keep up
// with the card's memory rate, twice int8's.
//
// Both run on the split-K core (splitk_matmul.cuh) with its folded-int4
// load path: a ring stage of 64 byte rows x 128 columns carries 128 weight
// rows, its x slice holds the two pieces the low and high nibbles multiply,
// and the nibbles become bf16 by prmt, lop3 and one bf16x2 FMA (no I2F).
// The plan's chunks are 128 byte rows (256 weight rows), so Llama's down
// pass (F = 11008: 5504 byte rows) is 43 chunks. K6 is one launch of the
// core's one-weight pass (the pass K7's down projection runs), with the
// split count of ops/decode_matmul.split_plan(R, Din, Dout, folded=True):
// Mistral's qkv projection, 48 column tiles of 16 chunks, runs as 6
// splits of 2 or 3 chunks, 288 blocks of 128 columns. K7 keeps two
// launches: the gate/up pass writes h [R, F] whole in natural column
// order, and the down pass over h folds over F, pairing h columns f and
// f + F/2 by itself (the Pallas kernel pairs them in one grid step only
// because it accumulates the down product across sequential steps).

#include "splitk_matmul.cuh"

// K6. Returns the cudaError_t of the launch. x [R, Din] bf16, w layer li's
// [Din/2, Dout] folded int4 bytes, s layer li's [Dout] scales (fp32 when
// scale_f32, else bf16), y [R, Dout] bf16; all contiguous device memory,
// 1 <= R <= 64, Din % 256 == 0, Dout % 128 == 0; splits: the plan's split
// count, 1 .. min(8, Din / 256).
extern "C" int vl2_matmul_q4(const void* x, const void* w, const void* s,
                             void* y, int R, int Din, int Dout, int scale_f32,
                             int splits, void* stream) {
  return vl2_sk::matmul<true>(x, w, s, y, R, Din, Dout, scale_f32, splits,
                              static_cast<cudaStream_t>(stream));
}

// K7: vl2_ffn_q8's two launches over G/U layer li's [D/2, F] packs folded
// over D and Dn's [F/2, D] folded over F, each pass with its split count.
// 1 <= R <= 64, D and F multiples of 256.
extern "C" int vl2_ffn_q4(const void* x, const void* g, const void* gs,
                          const void* u, const void* us, const void* dn,
                          const void* ds, void* h, void* out, int R, int D,
                          int F, int scale_f32, int gu_splits, int dn_splits,
                          void* stream) {
  return vl2_sk::ffn<true>(x, g, gs, u, us, dn, ds, h, out, R, D, F,
                           scale_f32, gu_splits, dn_splits,
                           static_cast<cudaStream_t>(stream));
}
