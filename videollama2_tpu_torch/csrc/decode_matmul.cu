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
// bytes in flight (a 4096-column output cut into 32-column tiles gives 128
// blocks for 132 SMs, each with one chunk in flight), and the int8 -> bf16
// conversion (I2F and cvt run at 16 results a clock an SM).
//
// K5 runs on splitk_matmul.cuh, which answers all three: 128-column tiles
// (every weight row read is a whole line), split-K over 256-row chunks so
// that every SM holds about two blocks in both passes (the plan comes from
// ops/decode_matmul.ffn_split_plan), a 3- or 4-stage cp.async ring of raw
// int8 tiles (32 KB in flight a block with gate and up), int8 -> bf16 by
// prmt and one FADD on the way into the mma.sync fragments, and a
// fixed-order reduction of the splits' fp32 partials by the last block of
// each column tile, in the same launch. K5 is two launches: gate and up
// (the SwiGLU epilogue writes h [R, F] in bf16, the rounding the Pallas
// kernel applies), then down over h. PERF.md §6 gives its times on the
// H100 beside its bound (scripts/profile_torch_decode_ffn.py times it).
//
// K4 (and matmul_q8) still run on decode_matmul.cuh: a block owns 32 output
// columns over the whole reduction depth, with one 256-row chunk in flight,
// converted by I2F. Its o projection (4096 columns) gives 128 blocks on 132
// SMs; moving it onto the split-K core is later work.

#include "decode_matmul.cuh"
#include "splitk_matmul.cuh"

// K4. Returns the cudaError_t of the launch. x [R, Din] bf16, w layer li's
// [Din, Dout] int8, s layer li's [Dout] scales (fp32 when scale_f32, else
// bf16), y [R, Dout] bf16; all contiguous device memory, 1 <= R <= 64,
// Din % 256 == 0, Dout % 32 == 0.
extern "C" int vl2_matmul_q8(const void* x, const void* w, const void* s,
                             void* y, int R, int Din, int Dout, int scale_f32,
                             void* stream) {
  return vl2_mm::dispatch<false>(
      vl2_mm::make_params(x, w, s, nullptr, nullptr, y, R, Din, Dout), false,
      scale_f32, static_cast<cudaStream_t>(stream));
}

// K5: two launches on one stream. h [R, F] = bf16(silu((x @ G) * gs) *
// ((x @ U) * us)), then out [R, D] = bf16((h @ Dn) * ds), with G/U layer
// li's [D, F] int8, Dn its [F, D], gs/us/ds their scales (fp32 when
// scale_f32, else bf16). Each pass has its split plan: its split count,
// the [splits + 1] chunk bounds, an fp32 workspace of tiles x splits x
// weights x R x 128 floats and [tiles] int32 counters that are 0 (and are 0
// again after the launch). 1 <= R <= 64, D and F multiples of 256.
extern "C" int vl2_ffn_q8(const void* x, const void* g, const void* gs,
                          const void* u, const void* us, const void* dn,
                          const void* ds, void* h, void* out, int R, int D,
                          int F, int scale_f32, int gu_splits,
                          const int* gu_bounds, void* gu_ws, int* gu_counters,
                          int dn_splits, const int* dn_bounds, void* dn_ws,
                          int* dn_counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vl2_sk::Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w[0] = static_cast<const int8_t*>(g);
  p.w[1] = static_cast<const int8_t*>(u);
  p.s[0] = gs;
  p.s[1] = us;
  p.y = static_cast<__nv_bfloat16*>(h);
  p.ws = static_cast<float*>(gu_ws);
  p.counters = gu_counters;
  p.bounds = gu_bounds;
  p.R = R; p.Din = D; p.Dout = F; p.splits = gu_splits;
  int err = vl2_sk::dispatch<2>(p, scale_f32, st);
  if (err != 0) return err;
  p.x = static_cast<const __nv_bfloat16*>(h);
  p.w[0] = p.w[1] = static_cast<const int8_t*>(dn);
  p.s[0] = p.s[1] = ds;
  p.y = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(dn_ws);
  p.counters = dn_counters;
  p.bounds = dn_bounds;
  p.Din = F; p.Dout = D; p.splits = dn_splits;
  return vl2_sk::dispatch<1>(p, scale_f32, st);
}
