"""Module parity of the PyTorch port against the JAX package, in fp32 on the
CPU: the same numpy inputs and the same params (bridged by
checkpoint/from_jax) go through both. Tolerances are stated per test; they
cover fp32 rounding in different summation orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.core import config as cfglib
from videollama2_tpu.media import wire
from videollama2_tpu.models import connector as jconn
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.models import vit as jvit
from videollama2_tpu.multimodal import splice as jsplice
from videollama2_tpu.ops import conv as jconv
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.models import connector as tconn
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.models import vit as tvit
from videollama2_tpu_torch.multimodal import splice as tsplice
from videollama2_tpu_torch.ops import conv as tconv
from videollama2_tpu_torch.ops import layers as tlayers

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model(projector_type="stc_connector")
    jparams = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.asarray, jparams)
    return cfg, jparams, params_from_jax(host, cfg)


# -- primitives (fp32; 1e-5 unless stated) ----------------------------------

def test_norms_rope_dense_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    s = rng.standard_normal(32, dtype=np.float32)
    b = rng.standard_normal(32, dtype=np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(s), 1e-5).numpy(),
        _np(jlayers.rms_norm(x, s, 1e-5)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlayers.layer_norm(_t(x), _t(s), _t(b), 1e-6).numpy(),
        _np(jlayers.layer_norm(x, s, b, 1e-6)), rtol=1e-5, atol=1e-5)
    pos = rng.integers(0, 200, (2, 5)).astype(np.int32)
    cos_t, sin_t = tlayers.rope_table(_t(pos), 16, 1e4)
    cos_j, sin_j = jlayers.rope_table(jnp.asarray(pos), 16, 1e4)
    np.testing.assert_allclose(cos_t.numpy(), _np(cos_j), atol=1e-5)
    np.testing.assert_allclose(sin_t.numpy(), _np(sin_j), atol=1e-5)
    q = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 5, 2, 16), dtype=np.float32)
    qt, kt = tlayers.apply_rope(_t(q), _t(k), cos_t, sin_t)
    qj, kj = jlayers.apply_rope(q, k, cos_j, sin_j)
    np.testing.assert_allclose(qt.numpy(), _np(qj), atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), _np(kj), atol=1e-5)
    w = rng.standard_normal((32, 24), dtype=np.float32)
    bias = rng.standard_normal(24, dtype=np.float32)
    np.testing.assert_allclose(
        tlayers.dense(_t(x), {"kernel": _t(w), "bias": _t(bias)}).numpy(),
        _np(jlayers.dense(x, {"kernel": w, "bias": bias})), atol=1e-5)
    for name in ("quick_gelu", "gelu_pytorch_tanh", "gelu", "silu"):
        np.testing.assert_allclose(tlayers.ACT2FN[name](_t(x)).numpy(),
                                   _np(jlayers.ACT2FN[name](x)), atol=1e-5)
    # a folded int4 pack of w (dequantize branch, JAX's default)
    pack = jquant.quantize_int4(jnp.asarray(w), axis=-2)
    tp = {"kernel_q4": {"q4": _t(np.array(pack["q4"])),
                        "scale": _t(np.array(pack["scale"]))},
          "bias": _t(bias)}
    np.testing.assert_allclose(
        tlayers.dense(_t(x), tp).numpy(),
        _np(jlayers.dense(x, {"kernel_q4": {k: pack[k]
                                            for k in ("q4", "scale")},
                              "bias": bias})), atol=1e-5)


def test_convs_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 7, 8), dtype=np.float32)
    w = rng.standard_normal((3, 3, 1, 8), dtype=np.float32)
    b = rng.standard_normal(8, dtype=np.float32)
    np.testing.assert_allclose(
        tconv.conv2d(_t(x), _t(w), _t(b), padding=1, groups=8).numpy(),
        _np(jconv.conv2d(x, w, b, padding=1, groups=8)), atol=1e-5)
    w2 = rng.standard_normal((2, 2, 8, 6), dtype=np.float32)
    np.testing.assert_allclose(
        tconv.conv2d(_t(x), _t(w2), stride=2).numpy(),
        _np(jconv.conv2d(x, w2, stride=2)), atol=1e-5)
    x3 = rng.standard_normal((2, 4, 6, 6, 8), dtype=np.float32)
    w3 = rng.standard_normal((2, 2, 2, 8, 5), dtype=np.float32)
    b3 = rng.standard_normal(5, dtype=np.float32)
    for pad in (0, 1):
        np.testing.assert_allclose(
            tconv.conv3d(_t(x3), _t(w3), _t(b3), stride=2, padding=pad)
            .numpy(),
            _np(jconv.conv3d(x3, w3, b3, stride=2, padding=pad)), atol=1e-5)
    np.testing.assert_allclose(
        tconv.avg_pool3d(_t(x3), (2, 2, 2)).numpy(),
        _np(jconv.avg_pool3d(x3, (2, 2, 2))), atol=1e-5)


def test_i420_unpack_equals_wire_reference():
    rng = np.random.default_rng(2)
    buf = rng.integers(0, 256, (2, 3, 24, 16), dtype=np.uint8)
    got = tvl2._i420_to_rgb(_t(buf)).numpy()
    np.testing.assert_array_equal(got, wire.i420_to_rgb(buf))


def test_splice_plan_equals_jax_and_composes():
    ids = [[1, 5, -201, 7], [1, -201, 9, 9, 9], [3, 4]]
    for tpm, seq in ((6, 16), (4, 8)):
        a = tsplice.plan_batch(ids, tpm, seq)
        b = jsplice.plan_batch(ids, tpm, seq)
        for f in ("text_ids", "is_visual", "vis_index", "valid_len",
                  "positions"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert tsplice.spliced_length(ids[1], tpm) == \
            jsplice.spliced_length(ids[1], tpm)
    assert tsplice.pick_bucket(70, (64, 128)) == \
        jsplice.pick_bucket(70, (64, 128))
    rng = np.random.default_rng(3)
    a = tsplice.plan_batch(ids, 6, 16)
    text = rng.standard_normal((3, 16, 8), dtype=np.float32)
    vis = rng.standard_normal((3, 6, 8), dtype=np.float32)
    got = tsplice.compose_embeds(_t(text), _t(vis), _t(a.is_visual),
                                 _t(a.vis_index))
    ref = jsplice.compose_embeds(text, vis, a.is_visual, a.vis_index)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


# -- models (fp32; 1e-4) ----------------------------------------------------

def test_vit_features_match_jax(tiny):
    cfg, jp, tp = tiny
    rng = np.random.default_rng(4)
    px = rng.standard_normal((3, 56, 56, 3), dtype=np.float32)
    ref = jvit.features(jp["vision"], cfg.vision, jnp.asarray(px),
                       attn_impl="xla")
    got = tvit.features(tp["vision"], cfg.vision, _t(px))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("ptype", ["stc_connector", "stc_connector_v35"])
def test_connector_matches_jax(ptype):
    cfg = cfglib.tiny_model(projector_type=ptype)
    jp = jconn.init_params(jax.random.PRNGKey(1), cfg.connector)
    tp = params_from_jax(
        {"connector": jax.tree.map(np.asarray, jp),
         "llm": jax.tree.map(np.asarray, jllm.init_params(
             jax.random.PRNGKey(2), cfg.llm)),
         "vision": jax.tree.map(np.asarray, jvit.init_params(
             jax.random.PRNGKey(3), cfg.vision))}, cfg)["connector"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 16, 32), dtype=np.float32)
    ref = jconn.apply(jp, cfg.connector, jnp.asarray(x))
    got = tconn.apply(tp, cfg.connector, _t(x))
    assert got.shape == ref.shape == (2, cfg.tokens_per_video, 64)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


def test_llm_prefill_and_decode_step_match_jax(tiny):
    cfg, jp, tp = tiny
    lc = cfg.llm
    B, S, M = 2, 16, 24
    rng = np.random.default_rng(6)
    embeds = rng.standard_normal((B, S, lc.hidden_size), dtype=np.float32)
    valid = np.array([S, 11], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    jcache = jllm.init_cache(lc, B, M, jnp.float32)
    jlast, jcache = jllm.prefill(jp["llm"], lc, jnp.asarray(embeds),
                                 jnp.asarray(pos), jnp.asarray(valid),
                                 jcache, attn_impl="xla")
    tcache = tllm.init_cache(lc, B, M, torch.float32)
    tlast, tcache = tllm.prefill(tp["llm"], lc, _t(embeds), _t(pos),
                                 _t(valid), tcache)
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), **TOL)
    np.testing.assert_allclose(tcache.k.numpy(), _np(jcache.k), **TOL)
    np.testing.assert_allclose(tcache.v.numpy(), _np(jcache.v), **TOL)
    np.testing.assert_allclose(
        tllm.lm_logits(tp["llm"], lc, tlast).numpy(),
        _np(jllm.lm_logits(jp["llm"], lc, jlast)), **TOL)

    step = 3
    tok = rng.standard_normal((B, 1, lc.hidden_size), dtype=np.float32)
    jlog, jcache = jllm.decode_step(jp["llm"], lc, jnp.asarray(tok), jcache,
                                    jnp.asarray(valid), S, jnp.int32(step))
    tlog, tcache = tllm.decode_step(tp["llm"], lc, _t(tok), tcache,
                                    _t(valid), S, step)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
    row = S + step   # the shared generated row this step wrote
    np.testing.assert_allclose(tcache.k[:, :, row].numpy(),
                               _np(jcache.k[:, :, row]), **TOL)
    np.testing.assert_allclose(tcache.v[:, :, row].numpy(),
                               _np(jcache.v[:, :, row]), **TOL)


def test_from_jax_checks_every_leaf(tiny):
    cfg, jp, _ = tiny
    host = jax.tree.map(np.asarray, jp)
    extra = dict(host, llm=dict(host["llm"], stray={"w": np.zeros(1)}))
    with pytest.raises(ValueError, match="not consumed"):
        params_from_jax(extra, cfg)
    missing = dict(host, llm={k: v for k, v in host["llm"].items()
                              if k != "final_norm"})
    with pytest.raises(KeyError):
        params_from_jax(missing, cfg)


@pytest.mark.parametrize("ptype", ["mlp2x_gelu", "stc_connector"])
def test_temporal_aggregator_pools_like_jax(ptype, monkeypatch):
    """The projector-type dispatch before the connector: mean over T for
    linear and mlp* projectors, [B, T, N, D] passed on for STC. The
    connector is replaced by the identity in both packages, so only the
    dispatch is compared (1e-6: a mean of four fp32 values)."""
    cfg = cfglib.tiny_model(projector_type=ptype)
    monkeypatch.setattr(jconn, "apply", lambda p, c, x: x)
    monkeypatch.setattr(tconn, "apply", lambda p, c, x: x)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, cfg.num_frames, 6,
                                 cfg.vision.hidden_size), dtype=np.float32)
    want = _np(jvl2.temporal_aggregator({"connector": {}}, cfg,
                                        jnp.asarray(feats)))
    got = tvl2.temporal_aggregator({"connector": {}}, cfg, _t(feats)).numpy()
    assert got.shape == want.shape
    assert want.ndim == (3 if ptype == "mlp2x_gelu" else 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
