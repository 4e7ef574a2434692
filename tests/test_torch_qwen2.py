"""The VideoLLaMA2.1 slice (SigLIP tower + STCv35 + Qwen2) of the PyTorch
port against the JAX package, on the CPU in fp32: the SigLIP tower, the
int8 embedding (`include_embed`), the bridge and the synthetic tree of
bench.py's qwen2 configuration, and `Engine.generate` on the tiny qwen2
model with its heads regrouped so that 7 query heads share a kv head, as in
Qwen2-7B (28 on 4): floating weights, and int8 layers, head, tower and
embedding, with an fp32 or an int8 KV cache.

Same inputs, made with numpy, go through both packages. The tower is held
to 1e-5 (fp32 rounding of two summation orders through two layers); the
slice's tolerances are those of tests/test_torch_engine.py: identical
greedy tokens, first-token logits to 1e-4 in fp32 and to 1e-2 where frames
are cast to bf16 before the tower (I420).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.constants import VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.media import wire
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.models import vit as jvit
from videollama2_tpu.multimodal import splice as jsplice
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.models import vit as tvit
from videollama2_tpu_torch.ops import quant as tquant
from videollama2_tpu_torch.utils import synthetic

TOWER_TOL = dict(rtol=1e-5, atol=1e-5)
FP32_LOGIT_ATOL = 1e-4
BF16_LOGIT_ATOL = 1e-2
NEW_TOKENS = 8
PROMPTS = [[1, 5, 9, VIDEO_TOKEN_INDEX, 17, 4],
           [1, 33, VIDEO_TOKEN_INDEX, 8, 2, 6, 200, 7]]


def _cfg():
    """tiny_model("videollama2_qwen2") (SigLIP, STCv35, Qwen2 with qkv
    biases) with 14 query heads on 2 kv heads of 8."""
    cfg = cfglib.tiny_model("videollama2_qwen2")
    return cfg.replace(llm=dataclasses.replace(cfg.llm, num_heads=14,
                                               num_kv_heads=2, head_dim=8))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _quantized(jp):
    """bench.py's qwen2 tree: int8 LLM layers and head, int8 embedding,
    int8 tower."""
    return dict(jp, llm=jquant.quantize_llm_params(jp["llm"],
                                                   include_embed=True),
                vision=jquant.quantize_vision_params(jp["vision"]))


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    assert cfg.vision.variant == "siglip"
    assert cfg.llm.num_heads // cfg.llm.num_kv_heads == 7
    jp = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(_host(jp), cfg)


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    cfg, jp, _ = tiny
    jq = _quantized(jp)
    return cfg, jq, params_from_jax(_host(jq), cfg)


def _videos(cfg, wire_fmt, seed):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    rgb = rng.integers(0, 256, (2, T, H, H, 3), dtype=np.uint8)
    if wire_fmt == "i420":
        return wire.rgb_to_i420(rgb)
    mean = np.asarray(cfg.vision.image_mean, np.float32)
    std = np.asarray(cfg.vision.image_std, np.float32)
    return ((rgb / np.float32(255.0) - mean) / std).astype(np.float32)


# -- the SigLIP tower ---------------------------------------------------------

@pytest.mark.parametrize("weights", ["float", "int8"])
def test_siglip_tower_matches_jax(tiny, tiny_int8, weights):
    """features() of the SigLIP tower: a patch projection with a bias, no
    CLS token and no pre-LayerNorm, gelu_pytorch_tanh; float weights, and
    int8 packs on the serving (W8A8) branch. W8A8 rounds activations to
    int8 a row, so an activation within ~1e-6 of a .5 boundary may round
    the other way in the other package (ROADMAP §3): pixels from seeds 0,
    4, 6 and 11 of 0-11 put one there and move 10-29 outputs by up to
    1.1e-4; these (seed 1) keep every W8A8 input clear."""
    cfg, jp, tp = tiny if weights == "float" else tiny_int8
    assert "cls_token" not in tp["vision"] and "pre_ln" not in tp["vision"]
    assert "bias" in tp["vision"]["patch_embed"]
    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, 56, 56, 3), dtype=np.float32)
    if weights == "float":
        ref = jvit.features(jp["vision"], cfg.vision, jnp.asarray(px),
                            attn_impl="xla")
    else:
        with jlayers.force_native_quant(), jlayers.quant_inference(), \
                jlayers.w8a8_prefill():
            ref = jvit.features(jp["vision"], cfg.vision, jnp.asarray(px),
                                attn_impl="xla")
    got = tvit.features(tp["vision"], cfg.vision, torch.from_numpy(px),
                        w8a8=weights == "int8")
    assert got.shape == ref.shape == (3, cfg.vision.num_patches,
                                      cfg.vision.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOWER_TOL)


# -- the int8 embedding -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_embed_is_bit_identical_and_gathers_equal(tiny, dtype):
    """quantize_llm_params(include_embed=True) packs the embedding as JAX
    does, one scale a row, and embed_tokens over the pack gives JAX's rows
    exactly (int8 rows and scales gathered, multiplied in fp32, cast)."""
    _, jp, tp = tiny
    jl, tl = jp["llm"], tp["llm"]
    if dtype == "bf16":
        jl = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jl)
        tl = jax.tree.map(lambda t: t.bfloat16(), tl)
    jq = jquant.quantize_llm_params(jl, include_embed=True)["embed"]
    tq = tquant.quantize_llm_params(tl, include_embed=True)["embed"]
    assert set(tq) == {"weight_q8"}
    for k in ("q", "scale"):
        np.testing.assert_array_equal(tq["weight_q8"][k].numpy(),
                                      np.asarray(jq["weight_q8"][k]))
    assert tq["weight_q8"]["scale"].shape == (512, 1)
    ids = np.array([[0, 7, 511], [3, 3, 200]], np.int32)
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = jllm.embed_tokens({"embed": jq}, jnp.asarray(ids), jdt)
        got = tllm.embed_tokens({"embed": tq}, torch.from_numpy(ids).long(),
                                tdt)
        assert got.dtype == (tdt or torch.float32)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_bridge_and_synthetic_tree_of_the_qwen2_bench(tiny):
    """params_from_jax takes bench.py's qwen2 tree (SigLIP tower, int8
    embed) and still raises on a leaf it does not use; synthetic_params
    with llm_bits=8 and quantize_embed packs exactly what quantizing its
    seeded float tree gives."""
    cfg, jp, _ = tiny
    host = _host(_quantized(jp))
    got = params_from_jax(host, cfg)
    assert set(got["llm"]["embed"]) == {"weight_q8"}
    assert set(got["vision"]["layers"]["qkv"]) == {"kernel_q8", "bias"}
    stray = dict(host, vision=dict(host["vision"],
                                   cls_token={"weight": np.zeros(32)}))
    with pytest.raises(ValueError, match="not consumed"):
        params_from_jax(stray, cfg)

    fp = synthetic.synthetic_params(cfg, torch.float32, "cpu", seed=4)
    q8 = synthetic.synthetic_params(cfg, torch.float32, "cpu", seed=4,
                                    llm_bits=8, quantize_embed=True)
    want = dict(fp, llm=tquant.quantize_llm_params(fp["llm"],
                                                   include_embed=True),
                vision=tquant.quantize_vision_params(fp["vision"]))
    flat = dict(_leaves(want))
    assert dict(_leaves(q8)).keys() == flat.keys()
    for path, t in _leaves(q8):
        assert t.dtype == flat[path].dtype, path
        assert torch.equal(t, flat[path]), path


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# -- the slice ----------------------------------------------------------------

def _first_logits(cfg, jp, tp, frames, w8a8=False):
    """First-token logits of PROMPTS through both packages' prefill."""
    bucket = 64
    plan = jsplice.plan_batch(PROMPTS, cfg.tokens_per_video, bucket)
    pos = np.broadcast_to(np.arange(bucket, dtype=np.int32), (2, bucket))
    jcache = jllm.init_cache(cfg.llm, 2, 128, jnp.float32)
    jlast, _ = jvl2.prefill_multimodal(
        jp, cfg, jnp.asarray(frames), jnp.asarray(plan.text_ids),
        jnp.asarray(plan.is_visual), jnp.asarray(plan.vis_index),
        jnp.asarray(pos), jnp.asarray(plan.valid_len), jcache)
    ref = np.asarray(jllm.lm_logits(jp["llm"], cfg.llm, jlast))
    tcache = tllm.init_cache(cfg.llm, 2, 128, torch.float32)
    with torch.inference_mode():
        tlast, _ = tvl2.prefill_multimodal(
            tp, cfg, torch.from_numpy(frames),
            torch.from_numpy(plan.text_ids).long(),
            torch.from_numpy(plan.is_visual),
            torch.from_numpy(plan.vis_index), torch.from_numpy(pos.copy()),
            torch.from_numpy(plan.valid_len), tcache, w8a8=w8a8)
        got = tllm.lm_logits(tp["llm"], cfg.llm, tlast, w8a8=w8a8).numpy()
    return got, ref


@pytest.mark.parametrize("wire_fmt", ["float", "i420"])
def test_qwen2_slice_matches_jax_engine(tiny, wire_fmt):
    """Floating weights, fp32 KV cache: greedy tokens identical to the JAX
    Engine's; first-token logits to 1e-4 (float frames) or 1e-2 (I420,
    bf16 tower)."""
    cfg, jp, tp = tiny
    frames = _videos(cfg, wire_fmt, seed=11)
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,))
    want = jeng.generate(PROMPTS, frames=frames,
                         gen=JaxGenerationConfig(max_new_tokens=NEW_TOKENS),
                         eos_token_id=-1)
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    got = eng.generate(PROMPTS, frames=frames,
                       gen=GenerationConfig(max_new_tokens=NEW_TOKENS),
                       eos_token_id=-1)
    assert got == want and all(len(o) == NEW_TOKENS for o in got)
    port, ref = _first_logits(cfg, jp, tp, frames)
    atol = FP32_LOGIT_ATOL if wire_fmt == "float" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol)
    assert [o[0] for o in got] == list(ref.argmax(-1))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_qwen2_int8_slice_matches_jax_engine(tiny_int8, kv_bits):
    """bench.py's BENCH_MODEL=qwen2 tree: int8 layers, head, tower and
    embedding (every prompt and decode token gathered from the int8
    table), W8A8 tower, prefill and head, decode on the layered int8
    kernels with K3 at 7 query heads a kv head (plain versions here;
    Pallas in interpret mode in the JAX Engine, under force_native_quant).
    Greedy tokens identical; int8 cache rows equal and their scales to
    1e-5 relative (as in tests/test_torch_engine.py); first-token logits
    to 1e-4."""
    cfg, jq, tq = tiny_int8
    frames = _videos(cfg, "float", seed=7)
    gen_kw = dict(max_new_tokens=NEW_TOKENS)
    jeng = JaxEngine(cfg, jq, dtype=jnp.float32, max_len=128, buckets=(64,),
                     kv_bits=kv_bits)
    eng = Engine(cfg, tq, dtype=torch.float32, max_len=128, buckets=(64,),
                 kv_bits=kv_bits, device="cpu")
    assert set(eng.params["llm"]["embed"]) == {"weight_q8"}
    caches = {}

    def keep_cache(name, decode_tail, at):
        def wrapped(*args, **kw):
            out = decode_tail(*args, **kw)
            caches[name] = out[at] if at is not None else args[2]
            return out
        return wrapped

    jeng._decode_tail = keep_cache("jax", jeng._decode_tail, 1)
    eng._decode_tail = keep_cache("port", eng._decode_tail, None)
    with jlayers.force_native_quant():
        want = jeng.generate(PROMPTS, frames=frames,
                             gen=JaxGenerationConfig(**gen_kw),
                             eos_token_id=-1)
    got = eng.generate(PROMPTS, frames=frames,
                       gen=GenerationConfig(**gen_kw), eos_token_id=-1)
    assert got == want
    jc, tc = caches["jax"], caches["port"]
    if kv_bits == 8:
        for name in ("k", "v"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       rtol=1e-5, atol=0)
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       rtol=0, atol=FP32_LOGIT_ATOL)
    with jlayers.force_native_quant(), jlayers.quant_inference(), \
            jlayers.w8a8_prefill():
        port, ref = _first_logits(cfg, jeng.params, eng.params, frames,
                                  w8a8=True)
    np.testing.assert_allclose(port, ref, rtol=0, atol=FP32_LOGIT_ATOL)
    assert [o[0] for o in got] == list(ref.argmax(-1))


@pytest.fixture(scope="module")
def tiny_int4(tiny):
    """bench.py's BENCH_MODEL=qwen2 BENCH_BITS=4 tree: folded int4 LLM
    layers (the fused qkv with its biases), an int8 head, tower and
    embedding."""
    cfg, jp, _ = tiny
    jq = dict(jp, llm=jquant.quantize_llm_params(jp["llm"], bits=4,
                                                 include_embed=True),
              vision=jquant.quantize_vision_params(jp["vision"]))
    return cfg, jq, params_from_jax(_host(jq), cfg)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_qwen2_int4_slice_matches_jax_engine(tiny_int4, kv_bits):
    """The 2.1 int4 path: W8A8 tower, W4A8 prefill with the qkv biases, the
    int8 embedding beside int4 layers, an int8 head, and decode on K3 and
    the int4 layered kernels at 7 query heads a kv head (plain versions
    here; Pallas in interpret mode in the JAX Engine, under
    force_native_quant). Greedy tokens identical; first-token logits to
    1e-4. Frames as in test_qwen2_int8_slice_matches_jax_engine."""
    cfg, jq, tq = tiny_int4
    frames = _videos(cfg, "float", seed=7)
    gen_kw = dict(max_new_tokens=NEW_TOKENS)
    jeng = JaxEngine(cfg, jq, dtype=jnp.float32, max_len=128, buckets=(64,),
                     kv_bits=kv_bits)
    eng = Engine(cfg, tq, dtype=torch.float32, max_len=128, buckets=(64,),
                 kv_bits=kv_bits, device="cpu")
    layers = eng.params["llm"]["layers"]
    assert set(layers["qkv"]) == {"kernel_q4", "bias"}
    assert set(eng.params["llm"]["embed"]) == {"weight_q8"}
    assert set(eng.params["llm"]["lm_head"]) == {"kernel_q8"}
    with jlayers.force_native_quant():
        want = jeng.generate(PROMPTS, frames=frames,
                             gen=JaxGenerationConfig(**gen_kw),
                             eos_token_id=-1)
    got = eng.generate(PROMPTS, frames=frames,
                       gen=GenerationConfig(**gen_kw), eos_token_id=-1)
    assert got == want and all(len(o) == NEW_TOKENS for o in got)
    with jlayers.force_native_quant(), jlayers.quant_inference(), \
            jlayers.w8a8_prefill():
        port, ref = _first_logits(cfg, jeng.params, eng.params, frames,
                                  w8a8=True)
    np.testing.assert_allclose(port, ref, rtol=0, atol=FP32_LOGIT_ATOL)
    assert [o[0] for o in got] == list(ref.argmax(-1))
