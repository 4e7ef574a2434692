"""The port's int8 and int4 decode paths against the JAX package, on the
CPU: the plain versions of K3 (decode attention), K4/K6 (layered int8 /
folded int4 matmul), K5/K7 (layered int8 / int4 SwiGLU FFN) and
`matmul_q8` against the Pallas kernels in interpret mode, and the LLM's
prefill and decode steps over int8 and int4 packs and an int8 KV cache.
The CUDA kernels themselves are held against the plain versions on a GPU
by tests/test_torch_cuda.py.

Same inputs, made with numpy, go through both packages in fp32. Kernel
tolerance 1e-5: fp32 rounding of two summation orders. Model steps 1e-4,
as in tests/test_torch_modules.py. int8 cache rows and their scales are
compared exactly: both packages quantize the same fp32 values with the
same quantizer.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.core import config as cfglib
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.ops import decode_matmul as jdk
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu.ops import quant_matmul as jqm
from videollama2_tpu.ops.decode_attention import \
    decode_attention_layered as jax_decode_attention
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.ops import decode_attention as k3
from videollama2_tpu_torch.ops import decode_matmul as k45
from videollama2_tpu_torch.ops import quant as tquant
from videollama2_tpu_torch.ops import quant_matmul as tqm

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- K3 ------------------------------------------------------------------------

def _caches(ck, cv, cache: str, K: int, hd: int):
    """fp32 cache values [L, B, M, K * hd] as the JAX and the port cache of
    kind `cache` (fp32, bf16, or int8 rows through each package's row
    quantizer with [L, B, K, M] scales): ((k, v, kwargs), (k, v, kwargs))."""
    if cache == "int8":
        L, B, M, _ = ck.shape
        kq, ks = jllm._quantize_kv_rows(jnp.asarray(ck).reshape(L, B, M, K,
                                                                hd))
        vq, vs = jllm._quantize_kv_rows(jnp.asarray(cv).reshape(L, B, M, K,
                                                                hd))
        jck, jcv = kq.reshape(L, B, M, -1), vq.reshape(L, B, M, -1)
        jargs = dict(k_scale=ks.transpose(0, 1, 3, 2),
                     v_scale=vs.transpose(0, 1, 3, 2))
        targs = {n: _t(np.asarray(a)) for n, a in jargs.items()}
        return (jck, jcv, jargs), (_t(np.asarray(jck)), _t(np.asarray(jcv)),
                                   targs)
    if cache == "bf16":
        return ((jnp.asarray(ck).astype(jnp.bfloat16),
                 jnp.asarray(cv).astype(jnp.bfloat16), {}),
                (_t(ck).bfloat16(), _t(cv).bfloat16(), {}))
    return (jnp.asarray(ck), jnp.asarray(cv), {}), (_t(ck), _t(cv), {})


@pytest.mark.parametrize("cache,window,block_m", [
    ("fp32", None, 32),     # blocks of 32 split M = 256
    ("bf16", None, 256),    # p rounded to bf16 before the PV product
    ("int8", None, 128),    # int8 rows, per-row scales; two blocks of M
    ("int8", 24, 128),      # sliding window on logical positions
    ("fp32", 24, 256),      # one block
])
def test_decode_attention_plain_matches_pallas(cache, window, block_m):
    rng = np.random.default_rng(5)
    B, H, K, hd, L, M = 3, 8, 2, 16, 3, 256
    li, prompt_len, step = 1, 96, 7                  # write_pos > prompt_len
    write_pos = prompt_len + step
    valid = np.array([17, 96, 60], np.int32)         # ragged
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k_new = rng.standard_normal((B, K, hd), dtype=np.float32)
    v_new = rng.standard_normal((B, K, hd), dtype=np.float32)
    ck = rng.standard_normal((L, B, M, K * hd), dtype=np.float32)
    cv = rng.standard_normal((L, B, M, K * hd), dtype=np.float32)
    (jck, jcv, jargs), (tck, tcv, targs) = _caches(ck, cv, cache, K, hd)
    want = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jck, jcv,
        jnp.int32(li), jnp.asarray(valid), jnp.int32(write_pos), prompt_len,
        window=window, block_m=block_m, interpret=True, **jargs)
    got = k3.decode_attention_layered(
        _t(q), _t(k_new), _t(v_new), tck, tcv, li, _t(valid), write_pos,
        prompt_len, window=window, **targs)
    assert got.shape == (B, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cache,window", [("bf16", None), ("bf16", 24),
                                          ("int8", None), ("int8", 24)])
def test_decode_attention_plain_matches_pallas_at_group_7(cache, window):
    """Qwen2-7B's grouping, 7 query heads a kv head (here 14 on 2, so the
    kv head of query head h is h // 7), bf16 and int8 caches, with and
    without a sliding window."""
    rng = np.random.default_rng(7)
    B, H, K, hd, L, M = 2, 14, 2, 16, 2, 256
    li, prompt_len, step = 1, 96, 5
    write_pos = prompt_len + step
    valid = np.array([96, 41], np.int32)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k_new = rng.standard_normal((B, K, hd), dtype=np.float32)
    v_new = rng.standard_normal((B, K, hd), dtype=np.float32)
    ck = rng.standard_normal((L, B, M, K * hd), dtype=np.float32)
    cv = rng.standard_normal((L, B, M, K * hd), dtype=np.float32)
    (jck, jcv, jargs), (tck, tcv, targs) = _caches(ck, cv, cache, K, hd)
    want = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jck, jcv,
        jnp.int32(li), jnp.asarray(valid), jnp.int32(write_pos), prompt_len,
        window=window, block_m=128, interpret=True, **jargs)
    got = k3.decode_attention_layered(
        _t(q), _t(k_new), _t(v_new), tck, tcv, li, _t(valid), write_pos,
        prompt_len, window=window, **targs)
    assert 7 in k3.SUPPORTED_GROUPS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- K4, K5 --------------------------------------------------------------------

def _pack(rng, L, din, dout):
    w = rng.standard_normal((L, din, dout), dtype=np.float32) * 0.05
    return jquant.quantize_int8(jnp.asarray(w), axis=-2)


@pytest.mark.parametrize("rows", [5, 16, 40])
def test_matmul_q8_layered_plain_matches_pallas(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 64), dtype=np.float32)
    pack = _pack(rng, 3, 64, 384)
    want = jdk.matmul_q8_layered(jnp.asarray(x), pack["q"], pack["scale"],
                                 jnp.int32(2), block_out=128, interpret=True)
    got = k45.matmul_q8_layered(_t(x), _t(np.asarray(pack["q"])),
                                _t(np.asarray(pack["scale"])), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ffn_q8_layered_plain_matches_pallas():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 64), dtype=np.float32)
    g, u, d = _pack(rng, 2, 64, 256), _pack(rng, 2, 64, 256), \
        _pack(rng, 2, 256, 64)
    want = jdk.ffn_q8_layered(jnp.asarray(x), g["q"], g["scale"], u["q"],
                              u["scale"], d["q"], d["scale"], jnp.int32(1),
                              block_f=128, interpret=True)   # two F blocks
    t = {k: _t(np.asarray(v)) for k, v in
         dict(gq=g["q"], gs=g["scale"], uq=u["q"], us=u["scale"],
              dq=d["q"], ds=d["scale"]).items()}
    got = k45.ffn_q8_layered(_t(x), t["gq"], t["gs"], t["uq"], t["us"],
                             t["dq"], t["ds"], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrappers_reject_other_devices_and_count_only_launches():
    x = torch.zeros(16, 256, device="meta")
    q = torch.zeros(2, 256, 64, dtype=torch.int8, device="meta")
    s = torch.zeros(2, 1, 64, device="meta")
    with pytest.raises(ValueError):
        k45.matmul_q8_layered(x, q, s, 0)
    with pytest.raises(ValueError):
        k45.ffn_q8_layered(x, q, s, q, s, q, s, 0)
    qd = torch.zeros(2, 4, 16, device="meta")
    with pytest.raises(ValueError):
        k3.decode_attention_layered(qd, qd, qd, q, q, 0, None, 1, 0)
    cpu = torch.randn(16, 256)
    qc = torch.randint(-127, 128, (2, 256, 64), dtype=torch.int8)
    k45.matmul_q8_layered(cpu, qc, torch.ones(2, 1, 64), 1)
    assert k45.matmul_q8_layered.launches == 0
    assert k45.ffn_q8_layered.launches == 0
    assert k3.decode_attention_layered.launches == 0


# -- K6, K7, matmul_q8 --------------------------------------------------------

def _pack4(rng, L, din, dout):
    w = rng.standard_normal((L, din, dout), dtype=np.float32) * 0.05
    pack = jquant.quantize_int4(jnp.asarray(w), axis=-2)
    return {"q": pack["q4"], "scale": pack["scale"]}


@pytest.mark.parametrize("rows", [5, 16, 40])
def test_matmul_q4_layered_plain_matches_pallas(rows):
    rng = np.random.default_rng(20 + rows)
    x = rng.standard_normal((rows, 64), dtype=np.float32)
    pack = _pack4(rng, 3, 64, 384)
    want = jdk.matmul_q4_layered(jnp.asarray(x), pack["q"], pack["scale"],
                                 jnp.int32(2), block_out=128, interpret=True)
    got = k45.matmul_q4_layered(_t(x), _t(pack["q"]), _t(pack["scale"]), 2)
    assert got.shape == (rows, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ffn_q4_layered_plain_matches_pallas():
    """Two F blocks a half: the Pallas kernel pairs F columns f and
    f + F/2 per grid step; the plain version writes h whole."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((5, 64), dtype=np.float32)
    g, u, d = _pack4(rng, 2, 64, 512), _pack4(rng, 2, 64, 512), \
        _pack4(rng, 2, 512, 64)
    want = jdk.ffn_q4_layered(jnp.asarray(x), g["q"], g["scale"], u["q"],
                              u["scale"], d["q"], d["scale"], jnp.int32(1),
                              block_f=128, interpret=True)
    args = [_t(p[k]) for p in (g, u, d) for k in ("q", "scale")]
    got = k45.ffn_q4_layered(_t(x), *args, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rows,scale_shape", [(5, "[F]"), (70, "[1, F]")])
def test_matmul_q8_plain_matches_pallas(rows, scale_shape):
    rng = np.random.default_rng(22 + rows)
    x = rng.standard_normal((rows, 64), dtype=np.float32)
    pack = jquant.quantize_int8(
        jnp.asarray(rng.standard_normal((64, 384), dtype=np.float32) * 0.05),
        axis=-2)
    scale = pack["scale"][0] if scale_shape == "[F]" else pack["scale"]
    want = jqm.matmul_q8(jnp.asarray(x), pack["q"], scale, block_f=128,
                         interpret=True)
    got = tqm.matmul_q8(_t(x), _t(pack["q"]), _t(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_q4_wrappers_reject_other_devices_and_count_only_launches():
    x = torch.zeros(16, 256, device="meta")
    q4 = torch.zeros(2, 128, 64, dtype=torch.int8, device="meta")
    s = torch.zeros(2, 1, 64, device="meta")
    with pytest.raises(ValueError):
        k45.matmul_q4_layered(x, q4, s, 0)
    with pytest.raises(ValueError):
        k45.ffn_q4_layered(x, q4, s, q4, s, q4, s, 0)
    with pytest.raises(ValueError):
        tqm.matmul_q8(x, q4[0], s[0])
    cpu = torch.randn(16, 256)
    qc = torch.randint(-128, 128, (2, 128, 64), dtype=torch.int8)
    k45.matmul_q4_layered(cpu, qc, torch.ones(2, 1, 64), 1)
    tqm.matmul_q8(cpu[:, :128], qc[0], torch.ones(64))
    assert k45.matmul_q4_layered.launches == 0
    assert k45.ffn_q4_layered.launches == 0
    assert tqm.matmul_q8.launches == 0


# -- the LLM over int8 packs ----------------------------------------------------

@pytest.fixture(scope="module")
def q8_llm():
    cfg = cfglib.tiny_llm("mistral")
    jp = jquant.fuse_qkv(jquant.quantize_llm_params(
        jllm.init_params(jax.random.PRNGKey(0), cfg)))
    return cfg, jp, jax.tree.map(lambda a: _t(np.array(a)), jp)


def _prefill_both(cfg, jp, tp, kv_bits, B=2, S=32, M=256):
    rng = np.random.default_rng(6)
    embeds = rng.standard_normal((B, S, cfg.hidden_size), dtype=np.float32)
    valid = np.array([S, 21], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jc = jllm.init_cache(cfg, B, M, jnp.float32, kv_bits=kv_bits)
    with jlayers.force_native_quant(), jlayers.w8a8_prefill():
        jlast, jc = jllm.prefill(jp, cfg, jnp.asarray(embeds),
                                 jnp.asarray(pos), jnp.asarray(valid), jc,
                                 attn_impl="xla")
    tc = tllm.init_cache(cfg, B, M, torch.float32, kv_bits=kv_bits)
    tlast, tc = tllm.prefill(tp, cfg, _t(embeds), _t(pos), _t(valid), tc,
                             w8a8=True)
    return valid, (jlast, jc), (tlast, tc)


def _assert_cache_equal(tc, jc, rows=slice(None)):
    if jc.k_scale is None:
        np.testing.assert_allclose(tc.k[:, :, rows].numpy(),
                                   np.asarray(jc.k[:, :, rows]), **STEP_TOL)
        np.testing.assert_allclose(tc.v[:, :, rows].numpy(),
                                   np.asarray(jc.v[:, :, rows]), **STEP_TOL)
        return
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got[:, :, rows].numpy(),
                                      np.asarray(want[:, :, rows]))
    for got, want in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
        np.testing.assert_allclose(got[..., rows].numpy(),
                                   np.asarray(want[..., rows]), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_q8_prefill_and_decode_steps_match_jax(q8_llm, kv_bits):
    """W8A8 prefill (head included) fills the cache, then two decode steps
    run on the layered kernels (plain versions here, Pallas in interpret
    mode there), over a bf16-layout or an int8 cache."""
    cfg, jp, tp = q8_llm
    S = 32
    valid, (jlast, jc), (tlast, tc) = _prefill_both(cfg, jp, tp, kv_bits, S=S)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **STEP_TOL)
    _assert_cache_equal(tc, jc, slice(0, S))
    with jlayers.force_native_quant(), jlayers.quant_inference():
        jlog0 = jllm.lm_logits(jp, cfg, jlast)
    np.testing.assert_allclose(tllm.lm_logits(tp, cfg, tlast, w8a8=True)
                               .numpy(), np.asarray(jlog0), **STEP_TOL)
    rng = np.random.default_rng(7)
    for step in (0, 1):
        tok = rng.standard_normal((2, 1, cfg.hidden_size), dtype=np.float32)
        with jlayers.force_native_quant(), jlayers.quant_inference():
            jlog, jc = jllm.decode_step(jp, cfg, jnp.asarray(tok), jc,
                                        jnp.asarray(valid), S,
                                        jnp.int32(step))
        tlog, tc = tllm.decode_step(tp, cfg, _t(tok), tc, _t(valid), S, step,
                                    w8a8=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **STEP_TOL)
    _assert_cache_equal(tc, jc)


def test_float_weights_decode_over_int8_cache_matches_jax():
    """Without int8 packs the generic decode reads the int8 cache
    dequantized, as JAX's XLA body does."""
    cfg = dataclasses.replace(cfglib.tiny_llm("qwen2"), sliding_window=20)
    jp = jllm.init_params(jax.random.PRNGKey(2), cfg)
    tp = jax.tree.map(lambda a: _t(np.array(a)), jp)
    tp["layers"]["qkv"] = {n: torch.cat([tp["layers"][p][n]
                                         for p in ("q", "k", "v")], -1)
                           for n in ("kernel", "bias")}
    for p in ("q", "k", "v"):
        del tp["layers"][p]
    S = 32
    valid, (jlast, jc), (tlast, tc) = _prefill_both(cfg, jp, tp, 8, S=S)
    tok = np.random.default_rng(8).standard_normal(
        (2, 1, cfg.hidden_size)).astype(np.float32)
    jlog, jc = jllm.decode_step(jp, cfg, jnp.asarray(tok), jc,
                                jnp.asarray(valid), S, jnp.int32(3))
    tlog, tc = tllm.decode_step(tp, cfg, _t(tok), tc, _t(valid), S, 3)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **STEP_TOL)
    _assert_cache_equal(tc, jc)


# -- the LLM over int4 packs ---------------------------------------------------

@pytest.fixture(scope="module")
def q4_llm():
    cfg = cfglib.tiny_llm("mistral")
    jp = jquant.fuse_qkv(jquant.quantize_llm_params(
        jllm.init_params(jax.random.PRNGKey(3), cfg), bits=4))
    return cfg, jp, jax.tree.map(lambda a: _t(np.array(a)), jp)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_q4_prefill_and_decode_steps_match_jax(q4_llm, kv_bits):
    """W4A8 prefill (int8 head) fills the cache, then two decode steps run
    on the int4 layered kernels (K6/K7: plain versions here, Pallas
    matmul_q4_layered / ffn_q4_layered in interpret mode there)."""
    cfg, jp, tp = q4_llm
    assert tllm._packed_decode(tp["layers"]) == 4
    S = 32
    valid, (jlast, jc), (tlast, tc) = _prefill_both(cfg, jp, tp, kv_bits, S=S)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **STEP_TOL)
    _assert_cache_equal(tc, jc, slice(0, S))
    rng = np.random.default_rng(23)
    for step in (0, 1):
        tok = rng.standard_normal((2, 1, cfg.hidden_size), dtype=np.float32)
        with jlayers.force_native_quant(), jlayers.quant_inference():
            jlog, jc = jllm.decode_step(jp, cfg, jnp.asarray(tok), jc,
                                        jnp.asarray(valid), S,
                                        jnp.int32(step))
        tlog, tc = tllm.decode_step(tp, cfg, _t(tok), tc, _t(valid), S, step,
                                    w8a8=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **STEP_TOL)
    _assert_cache_equal(tc, jc)
