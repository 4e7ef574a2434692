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
// streams 25 MB (qkv), 17 MB (o) and 176 MB (Mistral's FFN; 204 MB Qwen2's)
// of int8 weights for ~2 FLOPs a byte a row; the tensor cores idle. At the
// card's 3.35 TB/s an SM must take in ~14 weights a clock, and three things
// keep a kernel from that: reads narrower than a 128-byte line, too few
// bytes in flight (a 4096-column output cut into narrow tiles gives fewer
// blocks than SMs unless the reduction is split), and the int8 -> bf16
// conversion (I2F and cvt run at 16 results a clock an SM).
//
// Both run on the split-K core splitk_matmul.cuh, which answers all three:
// 128-column tiles (every weight row read is a whole line), split-K over
// 256-row chunks so that every SM holds about two blocks (the split count
// comes from ops/decode_matmul.split_plan: Mistral's o projection, 32 tiles
// of 16 chunks, runs as 8 splits), a 3- or 4-stage cp.async ring of raw
// int8 tiles, int8 -> bf16 by prmt and one FADD on the way into the
// mma.sync fragments, and a fixed-order reduction of the splits' fp32
// partials through the distributed shared memory of the tile's cluster, in
// the same launch. K4 is one launch (the core's one-weight pass); at the LM
// head's widths (250 tiles or more) the plan has one split and the blocks
// write y directly. K5 is two launches: gate and up (the SwiGLU epilogue
// writes h [R, F] in bf16, the rounding the Pallas kernel applies), then
// down over h. PERF.md §6 gives their times on the H100 beside their
// bounds (scripts/profile_torch_decode_ffn.py times them).

#include "splitk_matmul.cuh"

// K4. Returns the cudaError_t of the launch. x [R, Din] bf16, w layer li's
// [Din, Dout] int8, s layer li's [Dout] scales (fp32 when scale_f32, else
// bf16), y [R, Dout] bf16; all contiguous device memory, 1 <= R <= 64,
// Din % 256 == 0, Dout % 128 == 0; splits: the plan's split count, 1 ..
// min(8, Din / 256).
extern "C" int vl2_matmul_q8(const void* x, const void* w, const void* s,
                             void* y, int R, int Din, int Dout, int scale_f32,
                             int splits, void* stream) {
  return vl2_sk::matmul<false>(x, w, s, y, R, Din, Dout, scale_f32, splits,
                               static_cast<cudaStream_t>(stream));
}

// K5: two launches on one stream. h [R, F] = bf16(silu((x @ G) * gs) *
// ((x @ U) * us)), then out [R, D] = bf16((h @ Dn) * ds), with G/U layer
// li's [D, F] int8, Dn its [F, D], gs/us/ds their scales (fp32 when
// scale_f32, else bf16). Each pass has its split count (as K4's). 1 <= R
// <= 64, D and F multiples of 256.
extern "C" int vl2_ffn_q8(const void* x, const void* g, const void* gs,
                          const void* u, const void* us, const void* dn,
                          const void* ds, void* h, void* out, int R, int D,
                          int F, int scale_f32, int gu_splits, int dn_splits,
                          void* stream) {
  return vl2_sk::ffn<false>(x, g, gs, u, us, dn, ds, h, out, R, D, F,
                            scale_f32, gu_splits, dn_splits,
                            static_cast<cudaStream_t>(stream));
}
