"""The CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda` and skipped where there is no GPU (the kernels have no CPU
mode). This file imports no jax, so it runs where only PyTorch and the CUDA
toolkit are installed; the repository's tests/conftest.py imports jax, so
run it on the GPU host with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are bf16; the reference is the plain version in fp32 on the same
values. Attention tolerance 2e-2 absolute: the kernels round P to bf16 for
the PV product and round the output to bf16 (outputs here have |o| < ~3).
The int8 and int4 matmuls are held to 1e-2 relative to the output's scale:
bf16 output rounding (2^-9) and, for the FFNs, the bf16 rounding of h.
K2's LSE: 1e-3 absolute on values of ~5 (fp32 sums in another order, fast
exp). The backward kernels (K8, K9) get the same bf16 q, k, v, o, do and
the kernel's lse as the fp32 plain version, and are held to 2e-2 of
max|grad|: they round p and ds to bf16 (2^-9 relative) before the dv, dq
and dk products and round their outputs to bf16.
"""

import pytest
import torch

from videollama2_tpu_torch.models.llm import _quantize_kv_rows
from videollama2_tpu_torch.ops import decode_attention as k3
from videollama2_tpu_torch.ops import decode_matmul as k45
from videollama2_tpu_torch.ops import encoder_attention as k1
from videollama2_tpu_torch.ops import flash_attention as k2
from videollama2_tpu_torch.ops import quant_matmul
from videollama2_tpu_torch.ops.quant import quantize_int4, quantize_int8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


K1_TOL = 2e-2       # attention outputs: bf16 P and bf16 output rounding
K3_TOL = 2e-2


def _bf16_qkv(gen, B, S, Hq, Hkv, D, device):
    def r(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()
    return r(B, S, Hq, D), r(B, S, Hkv, D), r(B, S, Hkv, D)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(577, 64), (729, 72), (130, 64)])
def test_encoder_attention_cuda_matches_plain(cuda_device, S, D):
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    q, k, v = _bf16_qkv(gen, 3, S, 4, 4, D, cuda_device)
    valid = torch.tensor([S, S - 100, 1], dtype=torch.int32,
                         device=cuda_device)
    got = k1.encoder_attention(q, k, v, valid).float()
    ref = k1.encoder_attention_plain(q.float(), k.float(), v.float(), valid)
    torch.testing.assert_close(got, ref, rtol=0, atol=K1_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 577, 729, 1024])
def test_encoder_attention_cuda_fused_strided(cuda_device, S, D):
    """K1 on q/k/v as strided views of one fused [B, S, 3 * H * D] tensor,
    as the towers pass them: S on both sides of the 64-key tiles and the
    128-row query tiles, valid_len S, 1 and 0 (every key masked: mean(v)
    over all S keys)."""
    gen = torch.Generator(device=cuda_device).manual_seed(S * 100 + D)
    B, H = 3, 4
    qkv = torch.randn(B, S, 3 * H * D, generator=gen,
                      device=cuda_device).bfloat16()
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D))
               for i in range(3))
    assert q.stride(0) == S * 3 * H * D and q.stride(2) == D
    valid = torch.tensor([S, 1, 0], dtype=torch.int32, device=cuda_device)
    before = k1.encoder_attention.launches
    got = k1.encoder_attention(q, k, v, valid)
    assert k1.encoder_attention.launches == before + 1
    ref = k1.encoder_attention_plain(q.float(), k.float(), v.float(), valid)
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=K1_TOL)
    torch.testing.assert_close(got[2].float(),
                               v[2].float().mean(0, keepdim=True).expand(
                                   S, H, D), rtol=0, atol=K1_TOL)
    assert torch.equal(got, k1.encoder_attention(q, k, v, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,D", [(577, 16, 64), (729, 16, 72),
                                   (130, 4, 64)])
def test_encoder_attention_pairs_cuda_matches_plain_and_k1(cuda_device, S,
                                                           H, D):
    """K10 (pack_pairs=True) against its plain version and against K1
    (the same function; K1's mma.sync tiles and K10's wgmma tiles round
    differently, so the two agree within K1_TOL, not bit for bit)."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + H)
    q, k, v = _bf16_qkv(gen, 3, S, H, H, D, cuda_device)
    valid = torch.tensor([S, S - 100, 1], dtype=torch.int32,
                         device=cuda_device)
    before = (k1.encoder_attention.launches,
              k1.encoder_attention_pairs.launches)
    got = k1.encoder_attention(q, k, v, valid, pack_pairs=True)
    assert (k1.encoder_attention.launches,
            k1.encoder_attention_pairs.launches) == (before[0],
                                                     before[1] + 1)
    ref = k1.encoder_attention_pairs_plain(q.float(), k.float(), v.float(),
                                           valid)
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=K1_TOL)
    single = k1.encoder_attention(q, k, v, valid).float()
    torch.testing.assert_close(got.float(), single, rtol=0, atol=K1_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("S", [64, 577, 729, 1024])
def test_encoder_attention_pairs_cuda_fused_strided(cuda_device, S, D):
    """K10 on q/k/v as strided views of one fused [B, S, 3 * H * D] tensor
    (its TMA maps are built from the views' strides), valid_len S, a ragged
    one, 1 and 0 (every key masked: mean(v) over all S keys): against its
    plain version and against K1 within K1_TOL, one launch, and two runs
    bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(S * 10 + D)
    B, H = 4, 4
    qkv = torch.randn(B, S, 3 * H * D, generator=gen,
                      device=cuda_device).bfloat16()
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D))
               for i in range(3))
    valid = torch.tensor([S, S // 2 + 3, 1, 0], dtype=torch.int32,
                         device=cuda_device)
    before = k1.encoder_attention_pairs.launches
    got = k1.encoder_attention(q, k, v, valid, pack_pairs=True)
    assert k1.encoder_attention_pairs.launches == before + 1
    ref = k1.encoder_attention_pairs_plain(q.float(), k.float(), v.float(),
                                           valid)
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=K1_TOL)
    torch.testing.assert_close(got[3].float(),
                               v[3].float().mean(0, keepdim=True).expand(
                                   S, H, D), rtol=0, atol=K1_TOL)
    single = k1.encoder_attention(q, k, v, valid).float()
    torch.testing.assert_close(got.float(), single, rtol=0, atol=K1_TOL)
    assert torch.equal(got, k1.encoder_attention(q, k, v, valid,
                                                 pack_pairs=True))


@pytest.mark.cuda
def test_encoder_attention_pairs_cuda_refuses_views_tma_cannot_take(
        cuda_device):
    """TMA takes a view whose strides and base are multiples of 16 bytes:
    a fused row of 3 * H * D + 4 elements, or a base 8 bytes off, is
    refused before a launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    H, D = 4, 64
    before = k1.encoder_attention_pairs.launches
    odd_row = torch.randn(2, 128, 3 * H * D + 4, generator=gen,
                          device=cuda_device).bfloat16()
    shifted = torch.randn(2, 128, 3 * H * D + 8, generator=gen,
                          device=cuda_device).bfloat16()[..., 4:]
    for qkv in (odd_row, shifted):
        q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D))
                   for i in range(3))
        with pytest.raises(ValueError):
            k1.encoder_attention(q, k, v, pack_pairs=True)
    assert k1.encoder_attention_pairs.launches == before


@pytest.mark.cuda
def test_encoder_attention_pairs_cuda_refuses_odd_heads_and_dims(
        cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    before = k1.encoder_attention_pairs.launches
    for H, D in ((3, 64), (4, 80)):
        q, k, v = _bf16_qkv(gen, 1, 128, H, H, D, cuda_device)
        with pytest.raises(ValueError):
            k1.encoder_attention(q, k, v, pack_pairs=True)
    assert k1.encoder_attention_pairs.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cuda_matches_plain(cuda_device, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = _bf16_qkv(gen, 3, 300, 8, 2, 128, cuda_device)
    valid = torch.tensor([300, 157, 0], dtype=torch.int32, device=cuda_device)
    got = k2.flash_attention(q, k, v, valid, causal=causal).float()
    ref = k2.flash_attention_plain(q.float(), k.float(), v.float(), valid,
                                   causal=causal)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_cuda_matches_plain(cuda_device, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = _bf16_qkv(gen, 3, 300, 8, 2, 128, cuda_device)
    valid = torch.tensor([300, 157, 0], dtype=torch.int32, device=cuda_device)
    before = k2.flash_attention.launches
    out, lse = k2.flash_attention(q, k, v, valid, causal=causal,
                                  return_lse=True)
    assert k2.flash_attention.launches == before + 1
    ref_out, ref_lse = k2.flash_attention_plain(
        q.float(), k.float(), v.float(), valid, causal=causal,
        return_lse=True)
    torch.testing.assert_close(out.float(), ref_out, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    assert torch.all(lse[2] == -1e30)


BWD_REL_TOL = 2e-2  # of max|grad|: bf16 p and ds in the products


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(32, 8), (4, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_cuda_matches_plain(cuda_device, D, hq, hkv,
                                                causal):
    """K8 and K9 at S 300 (not a multiple of the 64-row tiles), valid_len
    S, an odd length below S, and 1."""
    gen = torch.Generator(device=cuda_device).manual_seed(D + hq + causal)
    S = 300
    q, k, v = _bf16_qkv(gen, 3, S, hq, hkv, D, cuda_device)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).bfloat16()
    valid = torch.tensor([S, 157, 1], dtype=torch.int32, device=cuda_device)
    o, lse = k2.flash_attention(q, k, v, valid, causal=causal,
                                return_lse=True)
    before = (k2.flash_attention_bwd_dq.launches,
              k2.flash_attention_bwd_dkv.launches)
    got = k2.flash_attention_bwd(q, k, v, o, lse, do, valid, causal)
    torch.cuda.synchronize()
    assert (k2.flash_attention_bwd_dq.launches,
            k2.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = k2.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), valid,
                                        causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        torch.testing.assert_close(
            g.float(), w, rtol=0, atol=BWD_REL_TOL * w.abs().max().item(),
            msg=lambda m, name=name: f"{name}: {m}")
    # keys at or past valid_len get exactly zero gradients
    assert torch.all(got[1][1, 157:] == 0) and torch.all(got[2][2, 1:] == 0)


@pytest.mark.cuda
def test_flash_attention_function_cuda_strided_qkv(cuda_device):
    """FlashAttention on q/k/v views of a fused projection (no copy), as
    the LLM layers pass them: gradients reach the fused tensor, equal to
    the plain backward's."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    B, S, H, K, D = 2, 256, 8, 2, 128
    qkv = torch.randn(B, S, (H + 2 * K) * D, generator=gen,
                      device=cuda_device).bfloat16().requires_grad_(True)
    valid = torch.tensor([256, 131], dtype=torch.int32, device=cuda_device)

    def split(t):
        return (t[..., :H * D].unflatten(-1, (H, D)),
                t[..., H * D:(H + K) * D].unflatten(-1, (K, D)),
                t[..., (H + K) * D:].unflatten(-1, (K, D)))
    do = torch.randn(B, S, H, D, generator=gen, device=cuda_device).bfloat16()
    out = k2.FlashAttention.apply(*split(qkv), valid, True, None)
    (grad,) = torch.autograd.grad(out, qkv, do)
    q, k, v = (t.detach() for t in split(qkv))
    o, lse = k2.flash_attention(q, k, v, valid, return_lse=True)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    want = torch.cat([g.float().flatten(-2) for g in
                      k2.flash_attention_bwd_plain(
                          q.float(), k.float(), v.float(), o.float(), lse,
                          do.float(), valid, True)], dim=-1)
    torch.testing.assert_close(grad.float(), want, rtol=0,
                               atol=BWD_REL_TOL * want.abs().max().item())


def _poison_allocator(device, *like):
    """Hands PyTorch's caching allocator blocks full of NaN of the sizes a
    call is about to allocate (two of each), so that an output row the
    kernel leaves unwritten reads as NaN rather than as whatever zeros
    fresh device memory holds."""
    junk = [torch.full(t.shape, float("nan"), dtype=t.dtype, device=device)
            for t in like for _ in range(2)]
    torch.cuda.synchronize()
    del junk


def _check_grads(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        torch.testing.assert_close(
            g.float(), w, rtol=0, atol=BWD_REL_TOL * w.abs().max().item(),
            msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (14, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_k2_k9_cuda_groups_and_ragged_rows(cuda_device, D,
                                                           hq, hkv, causal):
    """K2 (with and without its LSE), K8 and K9 at S 300 (not a multiple of
    the 128-row query and key tiles), 1, 4 and 7 query heads a kv head,
    valid_len S, 157, 0 and 1, against the plain versions. The valid_len 0
    row gives lse -1e30, o = mean(v) over all keys and zero gradients; keys
    at or past valid_len get exact zeros (K9 stores the tiles it skips);
    two calls of K2 and of K9 give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        D * 100 + hq * 2 + causal)
    S = 300
    q, k, v = _bf16_qkv(gen, 4, S, hq, hkv, D, cuda_device)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).bfloat16()
    valid = torch.tensor([S, 157, 0, 1], dtype=torch.int32,
                         device=cuda_device)
    before = k2.flash_attention.launches
    out = k2.flash_attention(q, k, v, valid, causal=causal)
    o, lse = k2.flash_attention(q, k, v, valid, causal=causal,
                                return_lse=True)
    assert k2.flash_attention.launches == before + 2
    assert torch.equal(out, o)
    ref_o, ref_lse = k2.flash_attention_plain(
        q.float(), k.float(), v.float(), valid, causal=causal,
        return_lse=True)
    torch.testing.assert_close(o.float(), ref_o, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    assert torch.all(lse[2] == -1e30)
    mean_v = v[2].float().mean(0).repeat_interleave(hq // hkv, dim=0)
    torch.testing.assert_close(o[2].float(), mean_v.expand(S, hq, D),
                               rtol=0, atol=2e-2)
    o2, lse2 = k2.flash_attention(q, k, v, valid, causal=causal,
                                  return_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)

    dq, delta = k2.flash_attention_bwd_dq(q, k, v, o, lse, do, valid, causal)
    _poison_allocator(cuda_device, k, v)
    before = k2.flash_attention_bwd_dkv.launches
    dk, dv = k2.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid,
                                        causal)
    assert k2.flash_attention_bwd_dkv.launches == before + 1
    _check_grads((dq, dk, dv), k2.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), valid,
        causal))
    for g in (dq, dk, dv):
        assert torch.all(g[2] == 0)
    for g in (dk, dv):
        assert torch.all(g[1, 157:] == 0) and torch.all(g[3, 1:] == 0)
    _poison_allocator(cuda_device, k, v)
    again = k2.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid,
                                       causal)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_k2_k9_cuda_fused_strided(cuda_device, D, causal):
    """K2 with its LSE, K8 and K9 on q/k/v as strided views of one fused
    [B, S, (Hq + 2 Hkv) D] projection (K2's and K9's TMA maps are built from
    the views' strides), S 300, 7 query heads a kv head, ragged valid_len:
    against the plain versions, and two calls bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(D + causal)
    B, S, H, K = 3, 300, 14, 2
    qkv = torch.randn(B, S, (H + 2 * K) * D, generator=gen,
                      device=cuda_device).bfloat16()
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + K) * D].unflatten(-1, (K, D))
    v = qkv[..., (H + K) * D:].unflatten(-1, (K, D))
    assert not q.is_contiguous() and k.stride(1) == (H + 2 * K) * D
    do = torch.randn(B, S, H, D, generator=gen, device=cuda_device).bfloat16()
    valid = torch.tensor([S, 200, 131], dtype=torch.int32,
                         device=cuda_device)
    o, lse = k2.flash_attention(q, k, v, valid, causal=causal,
                                return_lse=True)
    ref_o, ref_lse = k2.flash_attention_plain(
        q.float(), k.float(), v.float(), valid, causal=causal,
        return_lse=True)
    torch.testing.assert_close(o.float(), ref_o, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    got = k2.flash_attention_bwd(q, k, v, o, lse, do, valid, causal)
    _check_grads(got, k2.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), valid,
        causal))
    assert torch.equal(o, k2.flash_attention(q, k, v, valid, causal=causal))
    again = k2.flash_attention_bwd(q, k, v, o, lse, do, valid, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_k2_k9_cuda_long_rows(cuda_device, D, causal):
    """K2 with its LSE, K8 and K9 at S 1100: nine 128-key tiles against
    K2's 3-stage K/V ring and 18 64-row query tiles a head, 4 heads a kv
    head, against K9's 4-stage Q/dO ring, so both rings wrap many times;
    valid_len S, 1000 and 515. Against the plain versions, and K9 bit-equal
    over two calls."""
    gen = torch.Generator(device=cuda_device).manual_seed(D * 10 + causal)
    S = 1100
    q, k, v = _bf16_qkv(gen, 3, S, 8, 2, D, cuda_device)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).bfloat16()
    valid = torch.tensor([S, 1000, 515], dtype=torch.int32,
                         device=cuda_device)
    o, lse = k2.flash_attention(q, k, v, valid, causal=causal,
                                return_lse=True)
    ref_o, ref_lse = k2.flash_attention_plain(
        q.float(), k.float(), v.float(), valid, causal=causal,
        return_lse=True)
    torch.testing.assert_close(o.float(), ref_o, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    got = k2.flash_attention_bwd(q, k, v, o, lse, do, valid, causal)
    _check_grads(got, k2.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), valid,
        causal))
    again = k2.flash_attention_bwd(q, k, v, o, lse, do, valid, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [300, 1100])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (14, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_dq_cuda_matches_plain(cuda_device, S, D, hq,
                                                   hkv, causal):
    """K8 alone against its plain version: 1, 4 and 7 query heads a kv
    head; S 300 (not a multiple of the 128-row query block or the 64-key
    tiles) and S 1100 (18 key tiles through the 4-stage K/V ring, so it
    wraps many times); valid_len S, an odd length, 0 (every row fully
    masked: dq exactly zero, lse -1e30) and 1. dq within BWD_REL_TOL of
    max|dq|, delta within 1e-5 of max|delta|, one launch a call, every
    row written (the output blocks are poisoned with NaN first), and two
    calls bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        S + D * 10 + hq + causal)
    q, k, v = _bf16_qkv(gen, 4, S, hq, hkv, D, cuda_device)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).bfloat16()
    valid = torch.tensor([S, S // 2 + 7, 0, 1], dtype=torch.int32,
                         device=cuda_device)
    o, lse = k2.flash_attention(q, k, v, valid, causal=causal,
                                return_lse=True)
    assert torch.all(lse[2] == -1e30)
    _poison_allocator(cuda_device, q, lse)
    before = k2.flash_attention_bwd_dq.launches
    dq, delta = k2.flash_attention_bwd_dq(q, k, v, o, lse, do, valid, causal)
    assert k2.flash_attention_bwd_dq.launches == before + 1
    want_dq, want_delta = k2.flash_attention_bwd_dq_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), valid,
        causal)
    assert dq.dtype == torch.bfloat16 and delta.dtype == torch.float32
    torch.testing.assert_close(dq.float(), want_dq, rtol=0,
                               atol=BWD_REL_TOL * want_dq.abs().max().item())
    torch.testing.assert_close(delta, want_delta, rtol=0,
                               atol=1e-5 * want_delta.abs().max().item())
    assert torch.all(dq[2] == 0)
    _poison_allocator(cuda_device, q, lse)
    again = k2.flash_attention_bwd_dq(q, k, v, o, lse, do, valid, causal)
    assert torch.equal(dq, again[0]) and torch.equal(delta, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_dq_cuda_unequal_lengths(cuda_device, causal):
    """K8 with fewer query rows than keys (Sq 130, Sk 300; causal is
    top-left aligned, so row i sees keys 0..i): the block walks only the
    key tiles its rows see, and a q/k/v taken from fused projections."""
    gen = torch.Generator(device=cuda_device).manual_seed(31 + causal)
    B, Sq, Sk, H, K, D = 2, 130, 300, 8, 2, 128
    q = torch.randn(B, Sq, 2 * H * D, generator=gen,
                    device=cuda_device).bfloat16()[..., :H * D]
    q = q.unflatten(-1, (H, D))
    kv = torch.randn(B, Sk, 2 * K * D, generator=gen,
                     device=cuda_device).bfloat16()
    k = kv[..., :K * D].unflatten(-1, (K, D))
    v = kv[..., K * D:].unflatten(-1, (K, D))
    do = torch.randn(B, Sq, H, D, generator=gen, device=cuda_device).bfloat16()
    valid = torch.tensor([Sk, 77], dtype=torch.int32, device=cuda_device)
    o, lse = k2.flash_attention_plain(q.float(), k.float(), v.float(), valid,
                                      causal, return_lse=True)
    o = o.bfloat16()
    dq, delta = k2.flash_attention_bwd_dq(q, k, v, o, lse, do, valid, causal)
    want_dq, want_delta = k2.flash_attention_bwd_dq_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), valid,
        causal)
    torch.testing.assert_close(dq.float(), want_dq, rtol=0,
                               atol=BWD_REL_TOL * want_dq.abs().max().item())
    torch.testing.assert_close(delta, want_delta, rtol=0,
                               atol=1e-5 * want_delta.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv"])
def test_flash_attention_cuda_from_a_fresh_thread(cuda_device, kernel):
    """K2, K8 and K9 called first thing in a new host thread, as PyTorch's
    autograd worker calls the backward kernels: the tensor maps are
    encoded against the thread's current context, which such a thread has
    only once the entry has made it current."""
    import threading
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    q, k, v = _bf16_qkv(gen, 2, 256, 8, 2, 128, cuda_device)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).bfloat16()
    o, lse = k2.flash_attention(q, k, v, return_lse=True)
    delta = k2.attention_delta(o, do).contiguous()
    args = {"flash_attention": (q, k, v),
            "flash_attention_bwd_dq": (q, k, v, o, lse, do),
            "flash_attention_bwd_dkv": (q, k, v, do, lse, delta)}[kernel]
    fn = getattr(k2, kernel)
    want = fn(*args)
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = fn(*args)
            torch.cuda.synchronize()
        except Exception as e:  # reported in the main thread
            got["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive()
    assert "error" not in got, got.get("error")
    want = want if isinstance(want, tuple) else (want,)
    out = got["out"] if isinstance(got["out"], tuple) else (got["out"],)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
def test_flash_attention_cuda_refuses_views_tma_cannot_take(cuda_device):
    """K2, K8 and K9 take a view whose strides and base are multiples of 16
    bytes (what TMA takes): a fused row of (Hq + 2 Hkv) D + 4 elements, or a
    base 8 bytes off, is refused with ValueError before a launch, and so
    is an o or do whose base is 8 bytes off."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    H, K, D, S = 4, 2, 128, 128
    width = (H + 2 * K) * D
    before = (k2.flash_attention.launches,
              k2.flash_attention_bwd_dq.launches,
              k2.flash_attention_bwd_dkv.launches)
    odd_row = torch.randn(1, S, width + 4, generator=gen,
                          device=cuda_device).bfloat16()
    shifted = torch.randn(1, S, width + 8, generator=gen,
                          device=cuda_device).bfloat16()[..., 4:]
    for qkv in (odd_row, shifted):
        q = qkv[..., :H * D].unflatten(-1, (H, D))
        k = qkv[..., H * D:(H + K) * D].unflatten(-1, (K, D))
        v = qkv[..., (H + K) * D:width].unflatten(-1, (K, D))
        with pytest.raises(ValueError):
            k2.flash_attention(q, k, v, return_lse=True)
        rows = torch.zeros((1, H, S), device=cuda_device)
        with pytest.raises(ValueError):
            k2.flash_attention_bwd_dq(q, k, v, torch.zeros_like(q), rows,
                                      torch.zeros_like(q))
        with pytest.raises(ValueError):
            k2.flash_attention_bwd_dkv(q, k, v, torch.zeros_like(q), rows,
                                       rows)
    q, k, v = _bf16_qkv(gen, 1, S, H, K, D, cuda_device)
    good = torch.zeros_like(q)
    shifted = torch.zeros(q.numel() + 4, dtype=q.dtype,
                          device=cuda_device)[4:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    rows = torch.zeros((1, H, S), device=cuda_device)
    for o, do in ((shifted, good), (good, shifted)):
        with pytest.raises(ValueError):
            k2.flash_attention_bwd_dq(q, k, v, o, rows, do)
    with pytest.raises(ValueError):
        k2.flash_attention_bwd_dkv(q, k, v, shifted, rows, rows)
    assert (k2.flash_attention.launches,
            k2.flash_attention_bwd_dq.launches,
            k2.flash_attention_bwd_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("cache,window,hd,K", [("int8", None, 128, 8),
                                               ("bf16", None, 128, 8),
                                               ("int8", 100, 128, 8),
                                               ("bf16", None, 64, 8),
                                               ("int8", None, 64, 4),
                                               ("int8", None, 128, 16),
                                               ("bf16", None, 128, 32)])
def test_decode_attention_cuda_matches_plain(cuda_device, cache, window, hd,
                                             K):
    """32 query heads on K kv heads: groups of 4 (Mistral), 8, 2 and 1."""
    gen = torch.Generator(device=cuda_device).manual_seed(hd + K)
    B, H, L, M, prompt_len, step = 3, 32, 2, 512, 300, 37
    valid = torch.tensor([300, 211, 1], dtype=torch.int32,
                         device=cuda_device)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)
    q, k_new, v_new = r(B, H, hd).bfloat16(), r(B, K, hd), r(B, K, hd)
    ck, cv = r(L, B, M, K, hd), r(L, B, M, K, hd)
    kw = {}
    if cache == "int8":
        (ck, ks), (cv, vs) = _quantize_kv_rows(ck), _quantize_kv_rows(cv)
        kw = dict(k_scale=ks.transpose(2, 3).contiguous(),
                  v_scale=vs.transpose(2, 3).contiguous())
    ck = ck.reshape(L, B, M, K * hd).to(torch.int8 if cache == "int8"
                                        else torch.bfloat16)
    cv = cv.reshape(L, B, M, K * hd).to(ck.dtype)
    k_new, v_new = k_new.bfloat16(), v_new.bfloat16()
    args = (ck, cv, 1, valid, prompt_len + step, prompt_len)
    got = k3.decode_attention_layered(q, k_new, v_new, *args, window=window,
                                      **kw).float()
    ref = k3.decode_attention_plain(q.float(), k_new, v_new, *args,
                                    window=window, **kw)
    torch.testing.assert_close(got, ref.float(), rtol=0, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("cache,window", [("int8", None), ("bf16", None),
                                          ("int8", 100)])
def test_decode_attention_cuda_group_7(cuda_device, cache, window):
    """Qwen2-7B's grouping: 28 query heads on 4 kv heads of 128."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    B, H, K, hd, L, M, prompt_len, step = 3, 28, 4, 128, 2, 512, 300, 37
    valid = torch.tensor([300, 211, 1], dtype=torch.int32,
                         device=cuda_device)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)
    q = r(B, H, hd).bfloat16()
    k_new, v_new = r(B, K, hd).bfloat16(), r(B, K, hd).bfloat16()
    ck, cv = r(L, B, M, K, hd), r(L, B, M, K, hd)
    kw = {}
    if cache == "int8":
        (ck, ks), (cv, vs) = _quantize_kv_rows(ck), _quantize_kv_rows(cv)
        kw = dict(k_scale=ks.transpose(2, 3).contiguous(),
                  v_scale=vs.transpose(2, 3).contiguous())
    dtype = torch.int8 if cache == "int8" else torch.bfloat16
    ck, cv = (t.reshape(L, B, M, K * hd).to(dtype) for t in (ck, cv))
    args = (ck, cv, 1, valid, prompt_len + step, prompt_len)
    before = k3.decode_attention_layered.launches
    got = k3.decode_attention_layered(q, k_new, v_new, *args, window=window,
                                      **kw).float()
    assert k3.decode_attention_layered.launches == before + 1
    ref = k3.decode_attention_plain(q.float(), k_new, v_new, *args,
                                    window=window, **kw)
    torch.testing.assert_close(got, ref.float(), rtol=0, atol=2e-2)
    with pytest.raises(ValueError):        # 3 query heads a kv head
        k3.decode_attention_layered(q[:, :12].contiguous(), k_new, v_new,
                                    *args, **kw)
    assert k3.decode_attention_layered.launches == before + 1


def _decode_inputs(gen, device, B, H, K, hd, L, M, cache):
    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q = (r(B, H, hd) * 2).bfloat16()
    k_new, v_new = r(B, K, hd).bfloat16(), r(B, K, hd).bfloat16()
    ck, cv = r(L, B, M, K, hd), r(L, B, M, K, hd)
    kw = {}
    if cache == "int8":
        (ck, ks), (cv, vs) = _quantize_kv_rows(ck), _quantize_kv_rows(cv)
        kw = dict(k_scale=ks.transpose(2, 3).contiguous(),
                  v_scale=vs.transpose(2, 3).contiguous())
    dtype = torch.int8 if cache == "int8" else torch.bfloat16
    ck, cv = (t.reshape(L, B, M, K * hd).to(dtype) for t in (ck, cv))
    return q, k_new, v_new, ck, cv, kw


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["int8", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8])
def test_decode_attention_cuda_chunk_edges(cuda_device, cache, hd, G):
    """K3 at every group and head dim, both caches, with and without a
    window, with write_pos at 1 and on both sides of the 128-row chunk
    edges (the last chunk holding 1, 127 or 128 rows; the chunks past
    write_pos exit at once); two runs bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(G * 1000 + hd)
    B, K, L, M = 3, 2, 2, 384
    q, k_new, v_new, ck, cv, kw = _decode_inputs(
        gen, cuda_device, B, G * K, K, hd, L, M, cache)
    for write_pos in (1, 127, 128, 129, 255, 256, 257, 383):
        prompt_len = min(write_pos, 200)
        valid = torch.tensor([prompt_len, prompt_len // 2, 0],
                             dtype=torch.int32, device=cuda_device)
        for window in (None, 60):
            args = (ck, cv, 1, valid, write_pos, prompt_len)
            before = k3.decode_attention_layered.launches
            got = k3.decode_attention_layered(q, k_new, v_new, *args,
                                              window=window, **kw)
            assert k3.decode_attention_layered.launches == before + 1
            ref = k3.decode_attention_plain(q.float(), k_new, v_new, *args,
                                            window=window, **kw)
            torch.testing.assert_close(
                got.float(), ref.float(), rtol=0, atol=K3_TOL,
                msg=lambda m, w=write_pos, win=window:
                f"write_pos {w} window {win}: {m}")
            again = k3.decode_attention_layered(q, k_new, v_new, *args,
                                                window=window, **kw)
            assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 5, 20, 40, 64])
def test_matmul_q8_layered_cuda_matches_plain(cuda_device, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn(rows, 1024, generator=gen, device=cuda_device).bfloat16()
    pack = quantize_int8(torch.randn(2, 1024, 768, generator=gen,
                                     device=cuda_device) * 0.02, axis=-2)
    for scale in (pack["scale"], pack["scale"].bfloat16()):
        got = k45.matmul_q8_layered(x, pack["q"], scale, 1).float()
        ref = k45._mm_plain(x, pack["q"][1], scale[1])
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-2 * ref.abs().max().item())


def _q8_pack(gen, L, din, dout, device, f32):
    w = torch.randn(L, din, dout, generator=gen, device=device)
    p = quantize_int8(w * 0.05, axis=-2)
    return p["q"], p["scale"] if f32 else p["scale"].bfloat16()


# (Din, Dout) of the fused qkv and the o projections of Mistral-7B, Qwen2-7B
# and Llama-2-7B (Llama's o is Mistral's)
PROJECTIONS = [(4096, 6144), (4096, 4096), (3584, 4608), (3584, 3584),
               (4096, 12288)]


def _splitk_launches(call) -> list:
    """The names of the split-K core's kernels one call of `call` launches
    (torch.profiler), after a warm-up call."""
    call()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type.name == "CUDA" and "splitk_kernel" in e.name]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 16, 40, 64])
@pytest.mark.parametrize("din,dout", PROJECTIONS)
@pytest.mark.parametrize("f32", [False, True])
def test_matmul_q8_layered_cuda_split_k(cuda_device, rows, din, dout, f32):
    """K4 on the split-K core at the qkv and o widths of Mistral, Qwen2 and
    Llama (layer 1 of a two-layer pack), fp32 and bf16 scales: within 1e-2
    of max|out| of the plain version, two calls bit-equal (the splits'
    partials are summed in a fixed order), one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + din + dout
                                                          + f32)
    x = torch.randn(rows, din, generator=gen, device=cuda_device).bfloat16()
    q, s = _q8_pack(gen, 2, din, dout, cuda_device, f32)
    before = k45.matmul_q8_layered.launches
    got = k45.matmul_q8_layered(x, q, s, 1)
    again = k45.matmul_q8_layered(x, q, s, 1)
    assert k45.matmul_q8_layered.launches == before + 2
    assert torch.equal(got, again)
    ref = k45.matmul_q8_layered_plain(x.float(), q, s, 1)
    torch.testing.assert_close(got.float(), ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
def test_matmul_q8_layered_cuda_one_launch(cuda_device):
    """A K4 call is one CUDA kernel launch: the splits and their reduction
    happen inside it."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randn(16, 4096, generator=gen, device=cuda_device).bfloat16()
    q, s = _q8_pack(gen, 1, 4096, 4096, cuda_device, False)
    kernels = _splitk_launches(lambda: k45.matmul_q8_layered(x, q, s, 0))
    assert len(kernels) == 1, kernels


@pytest.mark.cuda
def test_matmul_q8_layered_cuda_refuses_untiled_widths(cuda_device):
    """Widths the split-K core does not tile raise before a launch: Dout
    672 (a multiple of 32, not of the 128-column tile), Din 640 (not a
    multiple of the 256-row chunk), more than 64 rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    before = (k45.matmul_q8_layered.launches, quant_matmul.matmul_q8.launches)
    for rows, din, dout in ((16, 512, 672), (16, 640, 512), (65, 512, 512)):
        x = torch.randn(rows, din, generator=gen,
                        device=cuda_device).bfloat16()
        q, s = _q8_pack(gen, 1, din, dout, cuda_device, False)
        with pytest.raises(ValueError):
            k45.matmul_q8_layered(x, q, s, 0)
        if rows <= 64:
            with pytest.raises(ValueError):
                quant_matmul.matmul_q8(x, q[0], s[0])
    assert (k45.matmul_q8_layered.launches,
            quant_matmul.matmul_q8.launches) == before


@pytest.mark.cuda
def test_ffn_q8_layered_cuda_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(16, 512, generator=gen, device=cuda_device).bfloat16()
    g, u = (_q8_pack(gen, 2, 512, 1536, cuda_device, False) for _ in "gu")
    d = _q8_pack(gen, 2, 1536, 512, cuda_device, False)
    got = k45.ffn_q8_layered(x, *g, *u, *d, 0).float()
    ref = k45.ffn_q8_layered_plain(x.float(), *g, *u, *d, 0)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 16, 40, 64])
@pytest.mark.parametrize("D,F", [(4096, 14336), (3584, 18944),
                                 (4096, 11008)])
@pytest.mark.parametrize("f32", [False, True])
def test_ffn_q8_layered_cuda_split_k(cuda_device, rows, D, F, f32):
    """K5's split-K core at Mistral's, Qwen2's and Llama's widths (one
    layer of a two-layer pack, layer 1), fp32 and bf16 scales: within 1e-2
    of max|out| of the plain version, two calls bit-equal (the splits'
    partials are summed in a fixed order), two launches a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + D + F + f32)
    x = torch.randn(rows, D, generator=gen, device=cuda_device).bfloat16()
    g, u = (_q8_pack(gen, 2, D, F, cuda_device, f32) for _ in "gu")
    d = _q8_pack(gen, 2, F, D, cuda_device, f32)
    before = k45.ffn_q8_layered.launches
    got = k45.ffn_q8_layered(x, *g, *u, *d, 1)
    again = k45.ffn_q8_layered(x, *g, *u, *d, 1)
    assert k45.ffn_q8_layered.launches == before + 2
    assert torch.equal(got, again)
    ref = k45.ffn_q8_layered_plain(x.float(), *g, *u, *d, 1)
    torch.testing.assert_close(got.float(), ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
def test_ffn_q8_layered_cuda_two_launches(cuda_device):
    """A K5 call is two CUDA kernel launches (gate/up, then down)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(16, 512, generator=gen, device=cuda_device).bfloat16()
    g, u = (_q8_pack(gen, 1, 512, 1536, cuda_device, False) for _ in "gu")
    d = _q8_pack(gen, 1, 1536, 512, cuda_device, False)
    kernels = _splitk_launches(lambda: k45.ffn_q8_layered(x, *g, *u, *d, 0))
    assert len(kernels) == 2, kernels


@pytest.mark.cuda
def test_ffn_q8_layered_cuda_refuses_untiled_widths(cuda_device):
    """Widths the split-K tiling does not take raise before a launch: F
    not a multiple of 128 (the column tile of the gate/up pass), D not a
    multiple of 256 (the down pass's chunk is F's; D's is the gate/up
    pass's), more than 64 rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    before = k45.ffn_q8_layered.launches
    for rows, D, F in ((16, 512, 1568), (16, 640, 1536), (65, 512, 1536)):
        x = torch.randn(rows, D, generator=gen, device=cuda_device).bfloat16()
        g, u = (_q8_pack(gen, 1, D, F, cuda_device, False) for _ in "gu")
        d = _q8_pack(gen, 1, F, D, cuda_device, False)
        with pytest.raises(ValueError):
            k45.ffn_q8_layered(x, *g, *u, *d, 0)
    assert k45.ffn_q8_layered.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 40, 600])
def test_dense_w8a8_cuda_matches_cpu(cuda_device, rows):
    """W8A8 on the card (torch._int_mm: rows padded past 16; from 512 rows
    on, the weight passed column-major) gives the CPU's int32-matmul
    result: the int8 operands and the int32 product are exact in both."""
    from videollama2_tpu_torch.ops.layers import dense_w8a8
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn(2, rows // 2, 1024, generator=gen)
    pack = quantize_int8(torch.randn(1024, 512, generator=gen) * 0.02,
                         axis=-2)
    want = dense_w8a8(x, pack)
    got = dense_w8a8(x.to(cuda_device),
                     {k: v.to(cuda_device) for k, v in pack.items()})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def _q4_pack(gen, L, din, dout, device):
    w = torch.randn(L, din, dout, generator=gen, device=device) * 0.02
    p = quantize_int4(w, axis=-2)
    return p["q4"], p["scale"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 5, 20, 40, 64])
def test_matmul_q4_layered_cuda_matches_plain(cuda_device, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(100 + rows)
    x = torch.randn(rows, 1024, generator=gen, device=cuda_device).bfloat16()
    q4, scale = _q4_pack(gen, 2, 1024, 768, cuda_device)
    for s in (scale, scale.bfloat16()):
        got = k45.matmul_q4_layered(x, q4, s, 1).float()
        ref = k45.matmul_q4_layered_plain(x.float(), q4, s, 1)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 16, 40, 64])
@pytest.mark.parametrize("din,dout", PROJECTIONS)
@pytest.mark.parametrize("f32", [False, True])
def test_matmul_q4_layered_cuda_split_k(cuda_device, rows, din, dout, f32):
    """K6 on the split-K core's one-weight folded-int4 pass at the qkv and
    o widths of Mistral, Qwen2 and Llama (layer 1 of a two-layer pack),
    fp32 and bf16 scales: within 1e-2 of max|out| of the plain version,
    two calls bit-equal (the splits' partials are summed in a fixed
    order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + din + dout
                                                          + f32 + 1)
    x = torch.randn(rows, din, generator=gen, device=cuda_device).bfloat16()
    q4, s = _q4_pack(gen, 2, din, dout, cuda_device)
    s = s if f32 else s.bfloat16()
    before = k45.matmul_q4_layered.launches
    got = k45.matmul_q4_layered(x, q4, s, 1)
    again = k45.matmul_q4_layered(x, q4, s, 1)
    assert k45.matmul_q4_layered.launches == before + 2
    assert torch.equal(got, again)
    ref = k45.matmul_q4_layered_plain(x.float(), q4, s, 1)
    torch.testing.assert_close(got.float(), ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
def test_matmul_q4_layered_cuda_one_launch(cuda_device):
    """A K6 call is one launch of the split-K core: the splits and their
    reduction happen inside it."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.randn(16, 4096, generator=gen, device=cuda_device).bfloat16()
    q4, s = _q4_pack(gen, 1, 4096, 6144, cuda_device)
    kernels = _splitk_launches(lambda: k45.matmul_q4_layered(x, q4, s, 0))
    assert len(kernels) == 1, kernels


@pytest.mark.cuda
def test_matmul_q4_layered_cuda_refuses_untiled_widths(cuda_device):
    """Widths the split-K core does not tile raise before a launch: Dout
    672 (a multiple of 32, which K6 took before it moved onto the core,
    not of the 128-column tile), Din 640 (not a multiple of the 256-row
    chunk), more than 64 rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    before = k45.matmul_q4_layered.launches
    for rows, din, dout in ((16, 512, 672), (16, 640, 512), (65, 512, 512)):
        x = torch.randn(rows, din, generator=gen,
                        device=cuda_device).bfloat16()
        q4, s = _q4_pack(gen, 1, din, dout, cuda_device)
        with pytest.raises(ValueError):
            k45.matmul_q4_layered(x, q4, s, 0)
    assert k45.matmul_q4_layered.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 33])
def test_ffn_q4_layered_cuda_matches_plain(cuda_device, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn(rows, 512, generator=gen, device=cuda_device).bfloat16()
    g, u = (_q4_pack(gen, 2, 512, 1536, cuda_device) for _ in range(2))
    d = _q4_pack(gen, 2, 1536, 512, cuda_device)
    g, u, d = ((q, s.bfloat16()) for q, s in (g, u, d))
    got = k45.ffn_q4_layered(x, *g, *u, *d, 1).float()
    ref = k45.ffn_q4_layered_plain(x.float(), *g, *u, *d, 1)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 16, 40, 64])
@pytest.mark.parametrize("D,F", [(4096, 14336), (3584, 18944),
                                 (4096, 11008)])
@pytest.mark.parametrize("f32", [False, True])
def test_ffn_q4_layered_cuda_split_k(cuda_device, rows, D, F, f32):
    """K7 on the split-K core's folded-int4 path at Mistral's, Qwen2's and
    Llama's widths (Llama's down pass: 5504 byte rows, 43 chunks), layer 1
    of a two-layer pack, fp32 and bf16 scales: within 1e-2 of max|out| of
    the plain version, two calls bit-equal, two launches a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + D + F + f32)
    x = torch.randn(rows, D, generator=gen, device=cuda_device).bfloat16()
    g, u = (_q4_pack(gen, 2, D, F, cuda_device) for _ in "gu")
    d = _q4_pack(gen, 2, F, D, cuda_device)
    g, u, d = ((q, s if f32 else s.bfloat16()) for q, s in (g, u, d))
    before = k45.ffn_q4_layered.launches
    got = k45.ffn_q4_layered(x, *g, *u, *d, 1)
    again = k45.ffn_q4_layered(x, *g, *u, *d, 1)
    assert k45.ffn_q4_layered.launches == before + 2
    assert torch.equal(got, again)
    ref = k45.ffn_q4_layered_plain(x.float(), *g, *u, *d, 1)
    torch.testing.assert_close(got.float(), ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
def test_ffn_q4_layered_cuda_two_launches(cuda_device):
    """A K7 call is two launches of the split-K core (gate/up, then
    down)."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    x = torch.randn(16, 512, generator=gen, device=cuda_device).bfloat16()
    g, u = (_q4_pack(gen, 1, 512, 1536, cuda_device) for _ in "gu")
    d = _q4_pack(gen, 1, 1536, 512, cuda_device)
    kernels = _splitk_launches(lambda: k45.ffn_q4_layered(x, *g, *u, *d, 0))
    assert len(kernels) == 2, kernels


@pytest.mark.cuda
def test_ffn_q4_layered_cuda_refuses_untiled_widths(cuda_device):
    """Widths the split-K core does not tile raise before a launch: F not a
    multiple of 128 (1568, a multiple of 32; the gate/up pass's column
    tile), F not a multiple of 256 (1664: the down pass's chunk), D not a
    multiple of 256, more than 64 rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    before = k45.ffn_q4_layered.launches
    for rows, D, F in ((16, 512, 1568), (16, 512, 1664), (16, 640, 1536),
                       (65, 512, 1536)):
        x = torch.randn(rows, D, generator=gen, device=cuda_device).bfloat16()
        g, u = (_q4_pack(gen, 1, D, F, cuda_device) for _ in "gu")
        d = _q4_pack(gen, 1, F, D, cuda_device)
        with pytest.raises(ValueError):
            k45.ffn_q4_layered(x, *g, *u, *d, 0)
    assert k45.ffn_q4_layered.launches == before


@pytest.mark.cuda
def test_q4_kernels_refuse_bad_arguments(cuda_device):
    """Misaligned activations, a weight on another device, a layer out of
    range and a depth the kernel does not tile raise before a launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q4, scale = _q4_pack(gen, 2, 512, 256, cuda_device)
    x = torch.randn(16, 513, generator=gen, device=cuda_device).bfloat16()
    before = k45.matmul_q4_layered.launches
    with pytest.raises(ValueError):                 # rows not 16-byte aligned
        k45.matmul_q4_layered(x[:, 1:], q4, scale, 0)
    with pytest.raises(ValueError):                 # weight on the CPU
        k45.matmul_q4_layered(x[:, :512].contiguous(), q4.cpu(), scale, 0)
    with pytest.raises(ValueError):                 # layer out of range
        k45.matmul_q4_layered(x[:, :512].contiguous(), q4, scale, 2)
    with pytest.raises(ValueError):                 # Din 384: not tiled
        k45.matmul_q4_layered(x[:, :384].contiguous(),
                              q4[:, :192].contiguous(), scale, 0)
    with pytest.raises(ValueError):                 # down on the CPU
        k45.ffn_q4_layered(x[:, :512].contiguous(), q4, scale, q4, scale,
                           q4.cpu(), scale, 0)
    assert k45.matmul_q4_layered.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 100])
def test_matmul_q8_cuda_matches_plain(cuda_device, rows):
    """The non-layered matmul_q8 on K4's kernel, 64 rows a launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn(rows, 1024, generator=gen, device=cuda_device).bfloat16()
    pack = quantize_int8(torch.randn(1024, 640, generator=gen,
                                     device=cuda_device) * 0.02, axis=-2)
    before = quant_matmul.matmul_q8.launches
    got = quant_matmul.matmul_q8(x, pack["q"], pack["scale"]).float()
    assert quant_matmul.matmul_q8.launches - before == -(-rows // 64)
    ref = quant_matmul.matmul_q8_plain(x.float(), pack["q"], pack["scale"])
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 100])
def test_matmul_q8_cuda_lm_head(cuda_device, rows):
    """matmul_q8 at the Mistral LM head's 32000 columns: 250 column tiles,
    so one split, whose blocks write y from their registers (no workspace);
    within 1e-2 of max|out|, two calls bit-equal, 64 rows a launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(200 + rows)
    x = torch.randn(rows, 4096, generator=gen, device=cuda_device).bfloat16()
    pack = quantize_int8(torch.randn(4096, 32000, generator=gen,
                                     device=cuda_device) * 0.02, axis=-2)
    assert k45.split_plan(16, 4096, 32000, 1).splits == 1
    before = quant_matmul.matmul_q8.launches
    got = quant_matmul.matmul_q8(x, pack["q"], pack["scale"])
    again = quant_matmul.matmul_q8(x, pack["q"], pack["scale"])
    assert quant_matmul.matmul_q8.launches - before == 2 * -(-rows // 64)
    assert torch.equal(got, again)
    ref = quant_matmul.matmul_q8_plain(x.float(), pack["q"], pack["scale"])
    torch.testing.assert_close(got.float(), ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())
