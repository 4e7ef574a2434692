"""K4 and K5: layered int8 weight-only matmuls of the decode step.

CUDA kernels: `csrc/decode_matmul.cu` (built by `ops/_build.py`), which
replace videollama2_tpu/ops/decode_matmul.py::matmul_q8_layered (K4) and
::ffn_q8_layered (K5). The source's header says what bounds them on the
H100 and how their design answers. The plain versions below are the same
functions in PyTorch; the wrappers run them only for CPU tensors.

Packs (ops/quant): q int8 [L, Din, Dout], scale [L, 1, Dout] (fp32, or
the engine dtype after the Engine's cast); `layer` selects the slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

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


def ffn_q8_layered_plain(x, gate_q, gate_s, up_q, up_s, down_q, down_s,
                         layer: int) -> torch.Tensor:
    """Plain version of K5: h = silu(g * gs) * (u * us) rounded to x's
    dtype, out = (h @ D) * ds."""
    g = _mm_plain(x, gate_q[layer], gate_s[layer])
    u = _mm_plain(x, up_q[layer], up_s[layer])
    h = (F.silu(g) * u).to(x.dtype)
    return _mm_plain(h, down_q[layer], down_s[layer]).to(x.dtype)


def _check_x(x: torch.Tensor, din: int) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != din or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"x must be [R <= {MAX_ROWS}, {din}], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")


def _check_pack(name: str, q: torch.Tensor, scale: torch.Tensor, device,
                layer: int):
    """Checks an [L, Din, Dout] int8 pack; returns (Din, Dout, scale_f32)."""
    for t in (q, scale):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.int8 or q.dim() != 3:
        raise TypeError(f"{name} must be int8 [L, Din, Dout], got {q.dtype} "
                        f"{tuple(q.shape)}")
    L, din, dout = q.shape
    if scale.shape != (L, 1, dout) or scale.dtype not in (torch.float32,
                                                          torch.bfloat16):
        raise ValueError(f"{name} scale must be fp32/bf16 [{L}, 1, {dout}], "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if din % BLOCK_IN or dout % BLOCK_OUT:
        raise ValueError(f"{name}: Din % {BLOCK_IN} and Dout % {BLOCK_OUT} "
                         f"must be 0, got [{din}, {dout}]")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for L={L}")
    return din, dout, int(scale.dtype == torch.float32)


def matmul_q8_layered(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      layer: int) -> torch.Tensor:
    """x: [R, Din]; q: [L, Din, Dout] int8; scale: [L, 1, Dout].
    Returns [R, Dout] in x's dtype."""
    if x.device.type == "cpu":
        return matmul_q8_layered_plain(x, q, scale, layer)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_q8_layered: unsupported device {x.device}")
    din, dout, f32 = _check_pack("q", q, scale, x.device, layer)
    _check_x(x, din)
    y = torch.empty((x.shape[0], dout), dtype=x.dtype, device=x.device)
    err = _build.library().vl2_matmul_q8(
        x.data_ptr(), q[layer].data_ptr(), scale[layer].data_ptr(),
        y.data_ptr(), x.shape[0], din, dout, f32,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "matmul_q8_layered")
    matmul_q8_layered.launches += 1
    return y


def ffn_q8_layered(x: torch.Tensor, gate_q: torch.Tensor,
                   gate_s: torch.Tensor, up_q: torch.Tensor,
                   up_s: torch.Tensor, down_q: torch.Tensor,
                   down_s: torch.Tensor, layer: int) -> torch.Tensor:
    """Fused SwiGLU FFN over layer `layer` of int8 packs. x: [R, D];
    gate_q/up_q: [L, D, F]; down_q: [L, F, D]; scales [L, 1, .].
    Returns [R, D] in x's dtype."""
    if x.device.type == "cpu":
        return ffn_q8_layered_plain(x, gate_q, gate_s, up_q, up_s, down_q,
                                    down_s, layer)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_q8_layered: unsupported device {x.device}")
    d, f, gf32 = _check_pack("gate", gate_q, gate_s, x.device, layer)
    if _check_pack("up", up_q, up_s, x.device, layer) != (d, f, gf32):
        raise ValueError("up must match gate in shape and scale dtype")
    if _check_pack("down", down_q, down_s, x.device, layer) != (f, d, gf32):
        raise ValueError("down must be [L, F, D] with gate's scale dtype")
    _check_x(x, d)
    R = x.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library()
    h = torch.empty((R, f), dtype=x.dtype, device=x.device)
    err = lib.vl2_ffn_q8_gate_up(
        x.data_ptr(), gate_q[layer].data_ptr(), gate_s[layer].data_ptr(),
        up_q[layer].data_ptr(), up_s[layer].data_ptr(), h.data_ptr(), R, d,
        f, gf32, stream)
    _build.check(err, "ffn_q8_layered (gate/up)")
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    err = lib.vl2_matmul_q8(
        h.data_ptr(), down_q[layer].data_ptr(), down_s[layer].data_ptr(),
        out.data_ptr(), R, f, d, gf32, stream)
    _build.check(err, "ffn_q8_layered (down)")
    ffn_q8_layered.launches += 1
    return out


matmul_q8_layered.launches = 0
ffn_q8_layered.launches = 0
