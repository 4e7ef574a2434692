"""K4-K7: layered weight-only matmuls of the decode step.

CUDA kernels (built by `ops/_build.py`): `csrc/decode_matmul.cu`, which
replaces videollama2_tpu/ops/decode_matmul.py::matmul_q8_layered (K4) and
::ffn_q8_layered (K5), and `csrc/decode_matmul_q4.cu`, which replaces
::matmul_q4_layered (K6) and ::ffn_q4_layered (K7). All four run on the
split-K core `csrc/splitk_matmul.cuh` (over int8 packs, or folded int4
ones for K6 and K7), whose split plan `split_plan` computes here. The
sources' headers say what bounds them on the H100 and how their design
answers. The plain versions below are the same functions in PyTorch; the
wrappers run them only for CPU tensors.

Packs (ops/quant): int8 q [L, Din, Dout] or folded int4 q4 [L, Din/2,
Dout], scale [L, 1, Dout] (fp32, or the engine dtype after the Engine's
cast); `layer` selects the slice.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .quant import unpack_int4

MAX_ROWS = 64    # the kernels loop over at most four 16-row tiles
# The split-K core (csrc/splitk_matmul.cuh): 128-column tiles, chunks of
# 256 weight rows (256 int8 rows or 128 folded int4 byte rows), and as
# many splits of each tile's chunks as bring the blocks nearest to
# SPLIT_BLOCKS_PER_SM an SM (more splits add partial sums to reduce;
# scripts/profile_torch_decode_ffn.py --blocks-per-sm times the
# alternatives, PERF.md §6 has them), at most SPLIT_MAX: a tile's splits
# are one thread-block cluster, and 8 is the portable cluster size
SPLIT_TILE = 128
SPLIT_CHUNK = 256
SPLIT_BLOCKS_PER_SM = 2
SPLIT_MAX = 8
H100_SMS = 132


class SplitPlan(NamedTuple):
    """How the split-K core cuts one pass: `tiles` column tiles of
    SPLIT_TILE, each tile's chunks (of `chunk_rows` packed rows: 256 int8
    rows, or 128 folded int4 byte rows, 256 weight rows either way) cut
    into `splits` ranges [bounds[i], bounds[i + 1]), one block each (the
    kernel computes the same bounds from the split count)."""
    tiles: int
    splits: int
    bounds: tuple
    chunk_rows: int


@functools.lru_cache(maxsize=None)
def split_plan(rows: int, din: int, dout: int,
               folded: bool = False) -> SplitPlan:
    """The split plan of one pass of the split-K core over rows x [din ->
    dout] (K4's, or either pass of an FFN), over int8 or (folded) int4
    packs; din counts weight rows. The split count brings tiles x splits
    nearest to SPLIT_BLOCKS_PER_SM blocks an SM (halves round up), at
    least 1 and at most the chunk count and SPLIT_MAX; the chunks are
    spread as evenly as integers allow (the ranges differ by at most one
    chunk). Raises ValueError for a shape the kernel does not tile:
    1 <= rows <= 64, din % 256 == 0, dout % 128 == 0."""
    if not 1 <= rows <= MAX_ROWS or din % SPLIT_CHUNK or dout % SPLIT_TILE \
            or din <= 0 or dout <= 0:
        raise ValueError(f"the split-K core tiles 1 <= R <= {MAX_ROWS}, Din"
                         f" % {SPLIT_CHUNK} == 0 and Dout % {SPLIT_TILE} =="
                         f" 0, got R {rows}, Din {din}, Dout {dout}")
    tiles, chunks = dout // SPLIT_TILE, din // SPLIT_CHUNK
    target = SPLIT_BLOCKS_PER_SM * H100_SMS
    splits = max(1, min(chunks, SPLIT_MAX,
                        (2 * target + tiles) // (2 * tiles)))
    bounds = tuple(i * chunks // splits for i in range(splits + 1))
    return SplitPlan(tiles, splits, bounds,
                     SPLIT_CHUNK // 2 if folded else SPLIT_CHUNK)


def _mm_plain(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """(x @ q.to(x.dtype)) in fp32 accumulation, times fp32 scale; fp32."""
    return (x.float() @ q.to(x.dtype).float()) * scale.float()


def matmul_q8_layered_plain(x, q, scale, layer: int) -> torch.Tensor:
    """Plain version of K4: y = (x @ bf16(q[layer])) * scale[layer]."""
    return _mm_plain(x, q[layer], scale[layer]).to(x.dtype)


def matmul_q4_layered_plain(x, q4, scale, layer: int) -> torch.Tensor:
    """Plain version of K6: the folded nibbles of q4[layer] unpacked, then
    y = (x @ q) * scale[layer] with fp32 accumulation."""
    return _mm_plain(x, unpack_int4(q4[layer]), scale[layer]).to(x.dtype)


def _ffn_plain(x, g, gs, u, us, d, ds) -> torch.Tensor:
    """One layer's SwiGLU FFN over int8 weights: h = silu((x @ g) * gs) *
    ((x @ u) * us) rounded to x's dtype, out = (h @ d) * ds."""
    h = (F.silu(_mm_plain(x, g, gs)) * _mm_plain(x, u, us)).to(x.dtype)
    return _mm_plain(h, d, ds).to(x.dtype)


def ffn_q8_layered_plain(x, gate_q, gate_s, up_q, up_s, down_q, down_s,
                         layer: int) -> torch.Tensor:
    """Plain version of K5: the FFN over layer `layer` of int8 packs."""
    return _ffn_plain(x, gate_q[layer], gate_s[layer], up_q[layer],
                      up_s[layer], down_q[layer], down_s[layer])


def ffn_q4_layered_plain(x, gate_q4, gate_s, up_q4, up_s, down_q4, down_s,
                         layer: int) -> torch.Tensor:
    """Plain version of K7: K5's function over folded int4 packs (gate/up
    folded over D, down over F), unpacked."""
    return _ffn_plain(x, unpack_int4(gate_q4[layer]), gate_s[layer],
                      unpack_int4(up_q4[layer]), up_s[layer],
                      unpack_int4(down_q4[layer]), down_s[layer])


def _check_x(x: torch.Tensor, din: int) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != din or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"x must be [R <= {MAX_ROWS}, {din}], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")


def _check_pack(name: str, q: torch.Tensor, scale: torch.Tensor, device,
                layer: int, folded: bool = False):
    """Checks an [L, Din, Dout] int8 pack, or with folded an [L, Din/2,
    Dout] int4 one; returns (Din, Dout, scale_f32). The widths each kernel
    tiles are checked by its launch path."""
    for t in (q, scale):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.int8 or q.dim() != 3:
        raise TypeError(f"{name} must be int8 [L, Din, Dout], got {q.dtype} "
                        f"{tuple(q.shape)}")
    L, din, dout = q.shape
    din *= 2 if folded else 1
    if scale.shape != (L, 1, dout) or scale.dtype not in (torch.float32,
                                                          torch.bfloat16):
        raise ValueError(f"{name} scale must be fp32/bf16 [{L}, 1, {dout}], "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for L={L}")
    return din, dout, int(scale.dtype == torch.float32)


def _on_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def launch_matmul(name: str, bits: int, x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor, layer: int,
                  y: torch.Tensor = None) -> torch.Tensor:
    """Checks the arguments and launches K4 (bits 8) or K6 (bits 4, over
    the folded pack) once on layer `layer`: one launch of the split-K
    core's one-weight pass with its split plan, into y (or a new [R, Dout]
    tensor); counts nothing. Widths the core does not tile raise
    ValueError before the launch."""
    _on_cuda(name, x)
    folded = bits == 4
    din, dout, f32 = _check_pack("q4" if folded else "q", q, scale,
                                 x.device, layer, folded=folded)
    _check_x(x, din)
    splits = split_plan(x.shape[0], din, dout, folded).splits
    if y is None:
        y = torch.empty((x.shape[0], dout), dtype=x.dtype, device=x.device)
    err = getattr(_build.library(), f"vl2_matmul_q{bits}")(
        x.data_ptr(), q[layer].data_ptr(), scale[layer].data_ptr(),
        y.data_ptr(), x.shape[0], din, dout, f32, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    return y


def _launch_ffn(name: str, bits: int, x, gate_q, gate_s, up_q, up_s, down_q,
                down_s, layer: int) -> torch.Tensor:
    """K5 (bits 8) or K7 (bits 4): the gate/up pass with its SwiGLU
    epilogue writes h [R, F], then the down pass takes h; two launches of
    the split-K core, each with its split plan."""
    _on_cuda(name, x)
    folded = bits == 4
    d, f, f32 = _check_pack("gate", gate_q, gate_s, x.device, layer, folded)
    if _check_pack("up", up_q, up_s, x.device, layer, folded) != (d, f, f32):
        raise ValueError("up must match gate in shape and scale dtype")
    if _check_pack("down", down_q, down_s, x.device, layer,
                   folded) != (f, d, f32):
        raise ValueError("down must be gate transposed (F in, D out), with "
                         "gate's scale dtype")
    _check_x(x, d)
    R = x.shape[0]
    splits = (split_plan(R, d, f, folded).splits,
              split_plan(R, f, d, folded).splits)
    h = torch.empty((R, f), dtype=x.dtype, device=x.device)
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    err = getattr(_build.library(), f"vl2_ffn_q{bits}")(
        x.data_ptr(), gate_q[layer].data_ptr(), gate_s[layer].data_ptr(),
        up_q[layer].data_ptr(), up_s[layer].data_ptr(),
        down_q[layer].data_ptr(), down_s[layer].data_ptr(), h.data_ptr(),
        out.data_ptr(), R, d, f, f32, *splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    return out


def matmul_q8_layered(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      layer: int) -> torch.Tensor:
    """x: [R, Din]; q: [L, Din, Dout] int8; scale: [L, 1, Dout].
    Returns [R, Dout] in x's dtype."""
    if x.device.type == "cpu":
        return matmul_q8_layered_plain(x, q, scale, layer)
    y = launch_matmul("matmul_q8_layered", 8, x, q, scale, layer)
    matmul_q8_layered.launches += 1
    return y


def ffn_q8_layered(x: torch.Tensor, gate_q: torch.Tensor,
                   gate_s: torch.Tensor, up_q: torch.Tensor,
                   up_s: torch.Tensor, down_q: torch.Tensor,
                   down_s: torch.Tensor, layer: int) -> torch.Tensor:
    """Fused SwiGLU FFN over layer `layer` of int8 packs. x: [R, D];
    gate_q/up_q: [L, D, F]; down_q: [L, F, D]; scales [L, 1, .].
    Returns [R, D] in x's dtype."""
    args = (x, gate_q, gate_s, up_q, up_s, down_q, down_s, layer)
    if x.device.type == "cpu":
        return ffn_q8_layered_plain(*args)
    out = _launch_ffn("ffn_q8_layered", 8, *args)
    ffn_q8_layered.launches += 1
    return out


def matmul_q4_layered(x: torch.Tensor, q4: torch.Tensor,
                      scale: torch.Tensor, layer: int) -> torch.Tensor:
    """x: [R, Din]; q4: [L, Din/2, Dout] folded int4; scale: [L, 1, Dout].
    Returns [R, Dout] in x's dtype."""
    if x.device.type == "cpu":
        return matmul_q4_layered_plain(x, q4, scale, layer)
    y = launch_matmul("matmul_q4_layered", 4, x, q4, scale, layer)
    matmul_q4_layered.launches += 1
    return y


def ffn_q4_layered(x: torch.Tensor, gate_q4: torch.Tensor,
                   gate_s: torch.Tensor, up_q4: torch.Tensor,
                   up_s: torch.Tensor, down_q4: torch.Tensor,
                   down_s: torch.Tensor, layer: int) -> torch.Tensor:
    """Fused SwiGLU FFN over layer `layer` of folded int4 packs. x: [R, D];
    gate_q4/up_q4: [L, D/2, F] (folded over D); down_q4: [L, F/2, D]
    (folded over F); scales [L, 1, .]. Returns [R, D] in x's dtype."""
    args = (x, gate_q4, gate_s, up_q4, up_s, down_q4, down_s, layer)
    if x.device.type == "cpu":
        return ffn_q4_layered_plain(*args)
    out = _launch_ffn("ffn_q4_layered", 4, *args)
    ffn_q4_layered.launches += 1
    return out


matmul_q8_layered.launches = 0
ffn_q8_layered.launches = 0
matmul_q4_layered.launches = 0
ffn_q4_layered.launches = 0
