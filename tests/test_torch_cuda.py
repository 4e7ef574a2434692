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
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,D", [(577, 16, 64), (729, 16, 72),
                                   (130, 4, 64)])
def test_encoder_attention_pairs_cuda_matches_plain_and_k1(cuda_device, S,
                                                           H, D):
    """K10 (pack_pairs=True) against its plain version and against K1: the
    two kernels run the same tile step per head, so they agree bit for
    bit."""
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
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=2e-2)
    assert torch.equal(got, k1.encoder_attention(q, k, v, valid))


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


@pytest.mark.cuda
def test_ffn_q8_layered_cuda_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(16, 512, generator=gen, device=cuda_device).bfloat16()

    def pack(din, dout):
        w = torch.randn(2, din, dout, generator=gen, device=cuda_device)
        p = quantize_int8(w * 0.05, axis=-2)
        return p["q"], p["scale"].bfloat16()
    g, u, d = pack(512, 1536), pack(512, 1536), pack(1536, 512)
    got = k45.ffn_q8_layered(x, *g, *u, *d, 0).float()
    ref = k45.ffn_q8_layered_plain(x.float(), *g, *u, *d, 0)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-2 * ref.abs().max().item())


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
