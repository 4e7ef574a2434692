"""The port's int8 and folded int4 packs, KV-row quantizer and W8A8/W4A8
dense against the JAX package, on the CPU.

Packs, their dequantization, the row quantizer and the q/k/v fusion must
be bit-identical (assert_array_equal): both packages compute the amax and
the scale in the input's dtype, divide (not multiply by a reciprocal) and
round half to even. W8A8 and W4A8 dense are exact up to their final float
ops (an int32 product of the same int8 operands), so they are held to
1e-6 relative; the dequantize branches, fp32 products in another
summation order, to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.core import config as cfglib
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.ops import layers as tlayers
from videollama2_tpu_torch.ops import quant as tquant
from videollama2_tpu_torch.utils import synthetic


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor in `dtype` (bf16
    rounds from fp32 to nearest even in both)."""
    w = rng.standard_normal(shape, dtype=np.float32) * 0.05
    if dtype == "bf16":
        return jnp.asarray(w).astype(jnp.bfloat16), \
            torch.from_numpy(w).bfloat16()
    return jnp.asarray(w), torch.from_numpy(w)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _assert_trees_equal(got: dict, want: dict, dtypes: bool = True) -> None:
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for path in w:
        if dtypes:
            assert g[path].dtype == w[path].dtype, path
        np.testing.assert_array_equal(_np(g[path]), _np(w[path]),
                                      err_msg=".".join(path))


def _t(a):
    return torch.from_numpy(np.array(a))


def _host(tree):
    """numpy leaves for params_from_jax (bf16 widened to fp32, exactly)."""
    return jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_int8_bit_identical(dtype, axis):
    rng = np.random.default_rng(0)
    wj, wt = _pair(rng, (3, 48, 40), dtype)
    want = jquant.quantize_int8(wj, axis=axis)
    got = tquant.quantize_int8(wt, axis=axis)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        tquant.dequantize_int8(got, torch.float32).numpy(),
        np.asarray(jquant.dequantize_int8(want, jnp.float32)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_model_params_bit_identical(dtype):
    """quantize_llm_params (head included) and quantize_vision_params on
    the port's fused-qkv tree give exactly the JAX packs of the split
    tree, concatenated: one scale per output channel, so fusing commutes
    with quantizing."""
    cfg = cfglib.tiny_model(projector_type="stc_connector")
    jp = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(_host(jp), cfg)
    if dtype == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = jax.tree.map(lambda t: t.bfloat16(), tp)
    jq = dict(jp, llm=jquant.quantize_llm_params(jp["llm"]),
              vision=jquant.quantize_vision_params(jp["vision"]))
    want = params_from_jax(_host(jq), cfg)
    got = dict(tp, llm=tquant.quantize_llm_params(tp["llm"]),
               vision=tquant.quantize_vision_params(tp["vision"]))
    _assert_trees_equal(got, want, dtypes=dtype == "fp32")
    assert "kernel_q8" in got["llm"]["lm_head"]
    # the bridge takes packs already fused by JAX's fuse_qkv as they are
    fused = params_from_jax(_host(dict(jq, llm=jquant.fuse_qkv(jq["llm"]))),
                            cfg)
    _assert_trees_equal(fused, want)
    # int4 layers (the head stays int8), split and fused, through the bridge
    jq4 = dict(jp, llm=jquant.quantize_llm_params(jp["llm"], bits=4),
               vision=jquant.quantize_vision_params(jp["vision"]))
    want4 = params_from_jax(_host(jq4), cfg)
    got4 = dict(tp, llm=tquant.quantize_llm_params(tp["llm"], bits=4),
                vision=tquant.quantize_vision_params(tp["vision"]))
    _assert_trees_equal(got4, want4, dtypes=dtype == "fp32")
    assert set(got4["llm"]["layers"]["qkv"]) == {"kernel_q4"}
    assert "kernel_q8" in got4["llm"]["lm_head"]
    fused4 = params_from_jax(
        _host(dict(jq4, llm=jquant.fuse_qkv(jq4["llm"]))), cfg)
    _assert_trees_equal(fused4, want4)


def test_fuse_qkv_bit_identical():
    cfg = cfglib.tiny_llm("qwen2")        # with qkv biases
    jp = jquant.quantize_llm_params(
        jllm.init_params(jax.random.PRNGKey(1), cfg))
    want = jquant.fuse_qkv(jp)
    split = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    got = tquant.fuse_qkv(split)
    _assert_trees_equal(got["layers"]["qkv"],
                        jax.tree.map(np.asarray, want["layers"]["qkv"]),
                        dtypes=False)
    assert got["layers"]["qkv"]["kernel_q8"]["q"].dtype == torch.int8
    assert "q" not in got["layers"] and "o" in got["layers"]
    fp = {"layers": {n: {"kernel": torch.zeros(1)} for n in "qkv"}}
    assert tquant.fuse_qkv(fp) is fp


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_kv_rows_bit_identical(dtype):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (2, 3, 5, 4, 16), dtype)
    qj, sj = jllm._quantize_kv_rows(xj)
    qt, st = tllm._quantize_kv_rows(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_dense_int8_branches_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    w = rng.standard_normal((48, 40), dtype=np.float32) * 0.05
    bias = rng.standard_normal(40, dtype=np.float32)
    jpack = jquant.quantize_int8(jnp.asarray(w), axis=-2)
    tp = {"kernel_q8": tquant.quantize_int8(torch.from_numpy(w), axis=-2),
          "bias": torch.from_numpy(bias)}
    jp = {"kernel_q8": jpack, "bias": jnp.asarray(bias)}
    with jlayers.force_native_quant(), jlayers.w8a8_prefill():
        want = np.asarray(jlayers.dense(jnp.asarray(x), jp))
    got = tlayers.dense(torch.from_numpy(x), tp, w8a8=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jlayers.dense(jnp.asarray(x), jp))   # dequantize
    got = tlayers.dense(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # an int4 pack of the same weight takes the same two branches
    j4 = jquant.quantize_int4(jnp.asarray(w), axis=-2)
    jp4 = {"kernel_q4": {"q4": j4["q4"], "scale": j4["scale"]}}
    tp4 = {"kernel_q4": {"q4": _t(j4["q4"]), "scale": _t(j4["scale"])}}
    with jlayers.force_native_quant(), jlayers.w8a8_prefill():
        want = np.asarray(jlayers.dense(jnp.asarray(x), jp4))
    got = tlayers.dense(torch.from_numpy(x), tp4, w8a8=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlayers.dense(torch.from_numpy(x), tp4).numpy(),
        np.asarray(jlayers.dense(jnp.asarray(x), jp4)), rtol=1e-5, atol=1e-5)


def test_synthetic_int8_is_the_quantized_float_tree():
    """synthetic_params(llm_bits=8) packs, layer by layer, exactly what
    quantizing the seeded float tree gives."""
    cfg = cfglib.tiny_model(projector_type="stc_connector")
    fp = synthetic.synthetic_params(cfg, torch.float32, "cpu", seed=4)
    q8 = synthetic.synthetic_params(cfg, torch.float32, "cpu", seed=4,
                                    llm_bits=8)
    want = dict(fp, llm=tquant.quantize_llm_params(fp["llm"]),
                vision=tquant.quantize_vision_params(fp["vision"]))
    _assert_trees_equal(q8, want)


def test_synthetic_int4_is_the_quantized_float_tree():
    """synthetic_params(llm_bits=4): folded int4 LLM layers, an int8 head
    and an int8 tower, each exactly what quantizing the seeded float tree
    gives."""
    cfg = cfglib.tiny_model(projector_type="stc_connector")
    fp = synthetic.synthetic_params(cfg, torch.float32, "cpu", seed=4)
    q4 = synthetic.synthetic_params(cfg, torch.float32, "cpu", seed=4,
                                    llm_bits=4)
    want = dict(fp, llm=tquant.quantize_llm_params(fp["llm"], bits=4),
                vision=tquant.quantize_vision_params(fp["vision"]))
    _assert_trees_equal(q4, want)
    assert "kernel_q4" in q4["llm"]["layers"]["down"]
    assert "kernel_q8" in q4["llm"]["lm_head"]


def _int4_weights(rng, shape):
    """Weights on the int4 grid of their channel's scale: half-integer
    multiples (the .5 rounding boundaries) and exact +-7 (the clip), so
    both packages' rounding and clipping are exercised."""
    w = rng.integers(-14, 15, shape) / 2 * 0.01
    w[..., 0, :] = 0.07          # amax of every output channel (axis -2)
    w[..., 1, ::2] = -0.07
    return w.astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("axis", [-2, -1, 1])
def test_quantize_int4_bit_identical(dtype, axis):
    w = _int4_weights(np.random.default_rng(10), (3, 48, 40))
    if dtype == "bf16":
        wj, wt = jnp.asarray(w).astype(jnp.bfloat16), _t(w).bfloat16()
    else:
        wj, wt = jnp.asarray(w), _t(w)
    want = jquant.quantize_int4(wj, axis=axis)
    got = tquant.quantize_int4(wt, axis=axis)
    assert got["q4"].dtype == torch.int8
    assert got["q4"].shape == tuple(want["q4"].shape)
    for k in ("q4", "scale", "axis"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(
        tquant.dequantize_int4(got, torch.float32).numpy(),
        np.asarray(jquant.dequantize_int4(want, jnp.float32)))
    if axis == -2:
        np.testing.assert_array_equal(
            tquant.dequantize_int4_in(got["q4"], got["scale"],
                                      torch.float32).numpy(),
            np.asarray(jquant.dequantize_int4_in(want["q4"], want["scale"],
                                                 jnp.float32)))


def test_unpack_int4_column_major_is_the_same_plane():
    """The large-row W4A8 unpack writes the same int8 plane, column-major
    (the layout torch._int_mm takes fastest)."""
    w = _int4_weights(np.random.default_rng(11), (64, 24))
    q4 = tquant.quantize_int4(_t(w), axis=-2)["q4"]
    row_major = tquant.unpack_int4(q4)
    col_major = tquant.unpack_int4(q4, column_major=True)
    assert col_major.stride() == (1, 64)
    assert torch.equal(row_major, col_major)
    assert row_major.min() >= -7 and row_major.max() <= 7


def test_fuse_qkv_int4_bit_identical():
    cfg = cfglib.tiny_llm("qwen2")        # with qkv biases
    jp = jquant.quantize_llm_params(
        jllm.init_params(jax.random.PRNGKey(1), cfg), bits=4)
    want = jquant.fuse_qkv(jp)
    got = tquant.fuse_qkv(jax.tree.map(_t, jp))
    _assert_trees_equal(got["layers"]["qkv"],
                        jax.tree.map(np.asarray, want["layers"]["qkv"]),
                        dtypes=False)
    assert got["layers"]["qkv"]["kernel_q4"]["q4"].dtype == torch.int8
    assert "q" not in got["layers"] and "kernel_q4" in got["layers"]["o"]


@pytest.mark.parametrize("shape", [(2, 5, 48), (7, 48)])
def test_dense_int4_branches_match_jax(shape):
    """W4A8 (under force_native_quant + w8a8_prefill in JAX) and the
    dequantize branch (JAX's default), with a bias."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal((48, 40), dtype=np.float32) * 0.05
    bias = rng.standard_normal(40, dtype=np.float32)
    j4 = jquant.quantize_int4(jnp.asarray(w), axis=-2)
    jp = {"kernel_q4": {"q4": j4["q4"], "scale": j4["scale"]},
          "bias": jnp.asarray(bias)}
    tp = {"kernel_q4": tquant.quantize_kernel(_t(w), 4)["kernel_q4"],
          "bias": _t(bias)}
    with jlayers.force_native_quant(), jlayers.w8a8_prefill():
        want = np.asarray(jlayers.dense(jnp.asarray(x), jp))
    got = tlayers.dense(_t(x), tp, w8a8=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlayers.dense(_t(x), tp).numpy(),
                               np.asarray(jlayers.dense(jnp.asarray(x), jp)),
                               rtol=1e-5, atol=1e-5)


def test_jax_moe_over_quantized_packs_lacks_its_expert_kernels():
    """A fault of the reference, pinned (ROADMAP §3): JAX's
    quantize_llm_params packs the Mixtral experts' gate/up/down kernels
    (ops/quant.py:110-119), but its MoE FFN reads lp["gate"]["kernel"]
    (models/llm.py:248-251), so a quantized Mixtral tree raises KeyError
    and JAX runs Mixtral only in floating point. The port raises for MoE
    (not ported yet)."""
    cfg = cfglib.tiny_llm("mixtral")
    params = jllm.init_params(jax.random.PRNGKey(0), cfg)
    x = jnp.ones((1, 4, cfg.hidden_size), jnp.float32)   # 4 rows: dense
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    assert jllm._ffn_moe(x, lp, cfg).shape == x.shape
    qlp = jax.tree.map(lambda a: a[0], jquant.quantize_llm_params(
        params, bits=8)["layers"])
    with pytest.raises(KeyError, match="kernel"):
        jllm._ffn_moe(x, qlp, cfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllm.param_shapes(cfg, bits=8)
