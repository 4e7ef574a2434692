"""The port's flash-attention forward LSE and backward against the JAX
package's Pallas kernels (interpret mode on the CPU, fp32, matmul precision
"highest"), FlashAttention's gradients against autograd over the plain
attention, and the routing of `attend` to FlashAttention.

Same numpy inputs go through both packages. Tolerances: forward output and
LSE 2e-5 (fp32, two summation orders); gradients 2e-4, as the JAX
package's own backward tests hold its kernels to the XLA vjp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videollama2_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from videollama2_tpu.ops.flash_attention import \
    flash_attention_bwd as jax_flash_attention_bwd
from videollama2_tpu_torch.ops import attention as attn
from videollama2_tpu_torch.ops import flash_attention as k2

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

CASES = [  # causal, Hq, Hkv, valid_len, D
    (True, 4, 4, None, 32),
    (True, 4, 2, None, 32),          # GQA
    (True, 4, 2, (96, 40), 32),      # GQA + right padding
    (False, 4, 4, (96, 40), 32),     # encoder-style
    (True, 4, 2, (128, 77), 64),     # a head dim the kernels take
]


def _inputs(seed, B, S, hq, hkv, D):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return r(B, S, hq, D), r(B, S, hkv, D), r(B, S, hkv, D), r(B, S, hq, D)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal,hq,hkv,valid,D", CASES)
def test_forward_lse_matches_pallas(causal, hq, hkv, valid, D):
    B, S = 2, 128
    q, k, v, _ = _inputs(D + hkv, B, S, hq, hkv, D)
    vl = None if valid is None else np.asarray(valid, np.int32)
    scale = D ** -0.5
    j_out, j_lse = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if vl is None else jnp.asarray(vl), causal, scale,
        return_lse=True, interpret=True)
    out, lse = k2.flash_attention(*_t(q, k, v),
                                  None if vl is None else torch.from_numpy(vl),
                                  causal, scale, return_lse=True)
    assert lse.shape == (B, hq, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               **FWD_TOL)


def test_fully_masked_row_lse():
    """valid_len == 0: the output is mean(v) and the lse the -1e30 fill,
    and the backward gives zero gradients for that row (explicit mask)."""
    q, k, v, g = _t(*_inputs(3, 2, 128, 2, 2, 64))
    vl = torch.tensor([128, 0], dtype=torch.int32)
    out, lse = k2.flash_attention(q, k, v, vl, True, return_lse=True)
    assert torch.all(lse[1] == -1e30)
    torch.testing.assert_close(out[1], v[1].mean(0).expand(128, 2, 64),
                               rtol=1e-5, atol=1e-5)
    dq, dk, dv = k2.flash_attention_bwd_plain(q, k, v, out, lse, g, vl, True)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
        assert torch.all(t[1] == 0)


@pytest.mark.parametrize("causal,hq,hkv,valid,D", CASES)
def test_backward_plain_matches_pallas(causal, hq, hkv, valid, D):
    B, S = 2, 128
    q, k, v, g = _inputs(10 + D + hkv, B, S, hq, hkv, D)
    vl = None if valid is None else np.asarray(valid, np.int32)
    scale = D ** -0.5
    jvl = None if vl is None else jnp.asarray(vl)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    j_out, j_lse = jax_flash_attention(jq, jk, jv, jvl, causal, scale,
                                       return_lse=True, interpret=True)
    j_grads = jax_flash_attention_bwd(jq, jk, jv, j_out, j_lse, jg, jvl,
                                      causal, scale, interpret=True)
    # the same o and lse (JAX's) go into the port's backward
    grads = k2.flash_attention_bwd_plain(
        *_t(q, k, v, np.asarray(j_out),
            np.ascontiguousarray(np.asarray(j_lse)[..., 0]), g),
        None if vl is None else torch.from_numpy(vl), causal, scale)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


@pytest.mark.parametrize("causal,hq,hkv,valid,D", CASES)
def test_kernel_halves_compose_to_the_backward(causal, hq, hkv, valid, D):
    """The per-kernel entry points (K8: dq and delta, K9: dk and dv from
    that delta) give flash_attention_bwd_plain's result on CPU tensors."""
    q, k, v, g = _t(*_inputs(20 + D, 2, 128, hq, hkv, D))
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    o, lse = k2.flash_attention(q, k, v, vl, causal, return_lse=True)
    dq, delta = k2.flash_attention_bwd_dq(q, k, v, o, lse, g, vl, causal)
    dk, dv = k2.flash_attention_bwd_dkv(q, k, v, g, lse, delta, vl, causal)
    want = k2.flash_attention_bwd_plain(q, k, v, o, lse, g, vl, causal)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    torch.testing.assert_close(delta, (o * g).sum(-1).transpose(1, 2))


@pytest.mark.parametrize("causal,valid", [(True, (128, 77)),
                                          (False, (128, 77)),
                                          (True, None)])
def test_flash_attention_function_grads_match_autograd(causal, valid):
    """FlashAttention.apply's gradients equal torch.autograd over the plain
    attention (every row has a valid key: a fully masked row's true
    gradient is not zero, and the flash backward defines it as zero)."""
    q, k, v, _ = _t(*_inputs(31, 2, 128, 4, 2, 64))
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 128, 4, 64)).astype(np.float32))

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        loss = (torch.tanh(fn(*ins)) * w).sum()
        return torch.autograd.grad(loss, ins)

    got = grads(lambda a, b, c: k2.FlashAttention.apply(a, b, c, vl, causal,
                                                        None))
    want = grads(lambda a, b, c: attn.attend_plain(a, b, c, vl, causal))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **GRAD_TOL)


def test_attend_routes_to_flash_attention_when_grads_are_needed(
        monkeypatch):
    calls = []
    real_apply = k2.FlashAttention.apply
    monkeypatch.setattr(k2.FlashAttention, "apply", staticmethod(
        lambda *a: calls.append("fa") or real_apply(*a)))
    real_k2 = k2.flash_attention
    monkeypatch.setattr(k2, "flash_attention", lambda *a, **kw: calls.append(
        "k2+lse" if kw.get("return_lse") else "k2") or real_k2(*a, **kw))
    q = torch.zeros(1, 128, 4, 64)
    kv = torch.zeros(1, 128, 2, 64)
    qg = q.clone().requires_grad_(True)
    out = attn.attend(qg, kv, kv, causal=True)           # needs a gradient
    assert calls == ["fa", "k2+lse"] and out.requires_grad
    with torch.no_grad():
        attn.attend(qg, kv, kv, causal=True)             # grad mode off
    attn.attend(q, kv, kv, causal=True)                  # nothing requires it
    assert calls == ["fa", "k2+lse", "k2", "k2"]
    # plain routes are unchanged: short sequences, odd head dims, windows
    for args, kw in (((torch.zeros(1, 64, 2, 64, requires_grad=True),) * 3,
                      {}),
                     ((torch.zeros(1, 128, 2, 16, requires_grad=True),) * 3,
                      {}),
                     ((torch.zeros(1, 128, 2, 64, requires_grad=True),) * 3,
                      dict(window=32))):
        assert attn.attend(*args, **kw).requires_grad
    assert calls == ["fa", "k2+lse", "k2", "k2"]


def test_kernel_calls_refuse_other_devices():
    x = torch.zeros(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError):
        k2.flash_attention_bwd(x, x, x, x, x, x)
    with pytest.raises(ValueError):
        k2.flash_attention_bwd_dkv(x, x, x, x, x, x)
    assert k2.flash_attention_bwd_dq.launches == 0
    assert k2.flash_attention_bwd_dkv.launches == 0
