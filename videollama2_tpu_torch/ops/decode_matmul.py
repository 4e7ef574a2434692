"""K4-K7: layered weight-only matmuls of the decode step.

CUDA kernels (built by `ops/_build.py`): `csrc/decode_matmul.cu`, which
replaces videollama2_tpu/ops/decode_matmul.py::matmul_q8_layered (K4) and
::ffn_q8_layered (K5), and `csrc/decode_matmul_q4.cu`, which replaces
::matmul_q4_layered (K6) and ::ffn_q4_layered (K7); both build on
`csrc/decode_matmul.cuh`. The sources' headers say what bounds them on the
H100 and how their design answers. The plain versions below are the same
functions in PyTorch; the wrappers run them only for CPU tensors.

Packs (ops/quant): int8 q [L, Din, Dout] or folded int4 q4 [L, Din/2,
Dout], scale [L, 1, Dout] (fp32, or the engine dtype after the Engine's
cast); `layer` selects the slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .quant import unpack_int4

MAX_ROWS = 64    # the kernels loop over at most four 16-row tiles
BLOCK_IN = 256   # csrc kBK: the reduction depth must be a multiple
BLOCK_OUT = 32   # csrc kBN: the output width must be a multiple


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
    Dout] int4 one; returns (Din, Dout, scale_f32)."""
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
    if din % BLOCK_IN or dout % BLOCK_OUT:
        raise ValueError(f"{name}: Din % {BLOCK_IN} and Dout % {BLOCK_OUT} "
                         f"must be 0, got Din {din}, Dout {dout}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for L={L}")
    return din, dout, int(scale.dtype == torch.float32)


def _on_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def launch_matmul(name: str, bits: int, x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor, layer: int,
                  y: torch.Tensor = None) -> torch.Tensor:
    """Checks the arguments and launches K4 (bits 8) or K6 (bits 4) once
    on layer `layer`, into y (or a new [R, Dout] tensor); counts nothing."""
    _on_cuda(name, x)
    din, dout, f32 = _check_pack("q4" if bits == 4 else "q", q, scale,
                                 x.device, layer, folded=bits == 4)
    _check_x(x, din)
    if y is None:
        y = torch.empty((x.shape[0], dout), dtype=x.dtype, device=x.device)
    err = getattr(_build.library(), f"vl2_matmul_q{bits}")(
        x.data_ptr(), q[layer].data_ptr(), scale[layer].data_ptr(),
        y.data_ptr(), x.shape[0], din, dout, f32,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    return y


def _launch_ffn(name: str, bits: int, x, gate_q, gate_s, up_q, up_s, down_q,
                down_s, layer: int) -> torch.Tensor:
    """K5 (bits 8) or K7 (bits 4): the gate/up pass with its SwiGLU
    epilogue writes h [R, F], then K4's or K6's kernel takes h through the
    down pack."""
    _on_cuda(name, x)
    folded = bits == 4
    d, f, gf32 = _check_pack("gate", gate_q, gate_s, x.device, layer, folded)
    if _check_pack("up", up_q, up_s, x.device, layer, folded) != (d, f, gf32):
        raise ValueError("up must match gate in shape and scale dtype")
    if _check_pack("down", down_q, down_s, x.device, layer,
                   folded) != (f, d, gf32):
        raise ValueError("down must be gate transposed (F in, D out), with "
                         "gate's scale dtype")
    _check_x(x, d)
    h = torch.empty((x.shape[0], f), dtype=x.dtype, device=x.device)
    err = getattr(_build.library(), f"vl2_ffn_q{bits}_gate_up")(
        x.data_ptr(), gate_q[layer].data_ptr(), gate_s[layer].data_ptr(),
        up_q[layer].data_ptr(), up_s[layer].data_ptr(), h.data_ptr(),
        x.shape[0], d, f, gf32,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{name} (gate/up)")
    return launch_matmul(f"{name} (down)", bits, h, down_q, down_s, layer)


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
