"""The PyTorch port's attention kernels: plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU; K10 against the packed
head-pair kernel, `pack_pairs=True`), the dispatch in `attend` and the
wrappers' checks. The CUDA kernels themselves are held
against the plain versions on a GPU by tests/test_torch_cuda.py.

Same inputs, made with numpy, go through both packages in fp32; the
tolerance 1e-5 is fp32 rounding of two different summation orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videollama2_tpu.ops.encoder_attention import \
    encoder_attention as jax_encoder_attention
from videollama2_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from videollama2_tpu_torch.ops import attention as attn
from videollama2_tpu_torch.ops import encoder_attention as k1
from videollama2_tpu_torch.ops import flash_attention as k2

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, B, S, Hq, Hkv, D):
    return (rng.standard_normal((B, S, Hq, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32))


@pytest.mark.parametrize("S", [48, 130])
@pytest.mark.parametrize("D", [64, 72])
def test_encoder_attention_plain_matches_pallas(S, D):
    rng = np.random.default_rng(S + D)
    B, H = 2, 4
    q, k, v = _qkv(rng, B, S, H, H, D)
    valid = np.array([S, S - 17], np.int32)
    ref = jax_encoder_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(valid),
                                interpret=True)
    got = k1.encoder_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,H,D,valid", [(2, 16, 64, [128, 77]),
                                         (1, 4, 72, [93])])
def test_encoder_attention_pairs_plain_matches_pallas(B, H, D, valid):
    """K10's plain version (pack_pairs=True) against the block-diagonal
    head-pair Pallas kernel at CLIP's and SigLIP's head dims, ragged
    valid_len."""
    rng = np.random.default_rng(H + D)
    S = 128
    q, k, v = _qkv(rng, B, S, H, H, D)
    valid = np.array(valid, np.int32)
    ref = jax_encoder_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(valid),
                                interpret=True, pack_pairs=True)
    got = k1.encoder_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(valid),
                               pack_pairs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_encoder_attention_pairs_needs_an_even_head_count():
    x = torch.zeros(1, 128, 3, 64)
    with pytest.raises(ValueError, match="even H"):
        k1.encoder_attention(x, x, x, pack_pairs=True)
    with pytest.raises(ValueError, match="even H"):
        k1.encoder_attention_pairs(x.to("meta"), x.to("meta"), x.to("meta"))
    assert k1.encoder_attention_pairs.launches == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [2, 4])
def test_flash_attention_plain_matches_pallas(causal, hkv):
    rng = np.random.default_rng(7 + hkv)
    B, S, Hq, D = 3, 256, 4, 128
    q, k, v = _qkv(rng, B, S, Hq, hkv, D)
    valid = np.array([S, 131, 0], np.int32)   # full, ragged, fully masked
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(valid),
                              causal=causal, interpret=True)
    got = k2.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(valid),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the valid_len == 0 row is mean(v) over all keys, for every query
    mean_v = v[2].mean(axis=0).repeat(Hq // hkv, axis=0)
    np.testing.assert_allclose(got[2].numpy(),
                               np.broadcast_to(mean_v, (S, Hq, D)), **TOL)


def test_attend_routes_like_the_tpu_rule(monkeypatch):
    calls = []
    monkeypatch.setattr(k1, "encoder_attention",
                        lambda *a, **kw: calls.append("k1") or a[0])
    monkeypatch.setattr(k2, "flash_attention",
                        lambda *a, **kw: calls.append("k2") or a[0])
    z = torch.zeros
    # CLIP tower: 577 tokens, unpadded, non-causal -> K1
    attn.attend(z(1, 577, 2, 64), z(1, 577, 2, 64), z(1, 577, 2, 64),
                causal=False)
    # SigLIP tower: 729 tokens at head dim 72 (JAX: XLA) -> K1
    attn.attend(z(1, 729, 2, 72), z(1, 729, 2, 72), z(1, 729, 2, 72),
                causal=False)
    # Mistral prefill: causal GQA -> K2
    attn.attend(z(1, 256, 4, 128), z(1, 256, 2, 128), z(1, 256, 2, 128),
                causal=True)
    assert calls == ["k1", "k1", "k2"]
    # sliding window, short sequences and head dims no kernel takes stay
    # plain
    for args, kw in (((z(1, 256, 2, 128),) * 3, dict(window=64)),
                     ((z(1, 64, 2, 128),) * 3, {}),
                     ((z(1, 256, 2, 80),) * 3, dict(causal=False))):
        out = attn.attend(*args, **kw)
        assert out.shape == args[0].shape
    assert calls == ["k1", "k1", "k2"]


def test_wrappers_reject_unsupported_devices():
    x = torch.zeros(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError):
        k1.encoder_attention(x, x, x)
    with pytest.raises(ValueError):
        k1.encoder_attention(x, x, x, pack_pairs=True)
    with pytest.raises(ValueError):
        k2.flash_attention(x, x, x)
    assert k1.encoder_attention.launches == 0
    assert k1.encoder_attention_pairs.launches == 0
    assert k2.flash_attention.launches == 0


def test_plain_kernels_do_not_count_launches():
    q = torch.randn(1, 128, 2, 64)
    k1.encoder_attention(q, q, q)
    k1.encoder_attention(q, q, q, pack_pairs=True)
    k2.flash_attention(q, q, q)
    assert k1.encoder_attention.launches == 0
    assert k1.encoder_attention_pairs.launches == 0
    assert k2.flash_attention.launches == 0
