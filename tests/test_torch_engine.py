"""The port's slice as a whole against the JAX package: the same tiny
VideoLLaMA2 (CLIP + STC + Mistral layout), the same params and the same
videos go through the JAX Engine and the port's Engine on the CPU in fp32.

Greedy tokens must be identical. First-token logits: with frames already
normalized in fp32 every stage runs in fp32 in both packages and the
logits agree to 1e-4 (FP32_LOGIT_ATOL). uint8 RGB and I420 frames are
normalized and then cast to bf16 before the tower (the JAX package's
rounding point), so tower and connector run in bf16 in both packages, and
XLA and PyTorch round bf16 products and elementwise chains at different
points: those logits differ by up to ~3e-3 at this size, held to
BF16_LOGIT_ATOL = 1e-2.
"""

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
from videollama2_tpu.multimodal import splice as jsplice
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2

FP32_LOGIT_ATOL = 1e-4
BF16_LOGIT_ATOL = 1e-2
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model(projector_type="stc_connector")
    jparams = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg)


def _videos(cfg, wire_fmt, seed=11):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    rgb = rng.integers(0, 256, (2, T, H, H, 3), dtype=np.uint8)
    if wire_fmt == "i420":
        return wire.rgb_to_i420(rgb)
    if wire_fmt == "float":
        mean = np.asarray(cfg.vision.image_mean, np.float32)
        std = np.asarray(cfg.vision.image_std, np.float32)
        return ((rgb / np.float32(255.0) - mean) / std).astype(np.float32)
    return rgb


PROMPTS = [[1, 5, 9, VIDEO_TOKEN_INDEX, 17, 4],
           [1, 33, VIDEO_TOKEN_INDEX, 8, 2, 6, 200, 7]]


def _first_logits_jax(cfg, jp, frames, plan, bucket):
    cache = jllm.init_cache(cfg.llm, 2, 128, jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(bucket), (2, bucket))
    last, _ = jvl2.prefill_multimodal(
        jp, cfg, jnp.asarray(frames), jnp.asarray(plan.text_ids),
        jnp.asarray(plan.is_visual), jnp.asarray(plan.vis_index), pos,
        jnp.asarray(plan.valid_len), cache)
    return np.asarray(jllm.lm_logits(jp["llm"], cfg.llm, last))


def _first_logits_port(cfg, tp, frames, plan, bucket, w8a8=False):
    cache = tllm.init_cache(cfg.llm, 2, 128, torch.float32)
    pos = torch.arange(bucket, dtype=torch.int32).expand(2, bucket)
    with torch.inference_mode():
        last, _ = tvl2.prefill_multimodal(
            tp, cfg, torch.from_numpy(frames),
            torch.from_numpy(plan.text_ids).long(),
            torch.from_numpy(plan.is_visual),
            torch.from_numpy(plan.vis_index),
            pos, torch.from_numpy(plan.valid_len), cache, w8a8=w8a8)
        return tllm.lm_logits(tp["llm"], cfg.llm, last, w8a8=w8a8).numpy()


@pytest.mark.parametrize("wire_fmt", ["float", "rgb", "i420"])
def test_slice_matches_jax_engine(tiny, wire_fmt):
    cfg, jp, tp = tiny
    frames = _videos(cfg, wire_fmt)
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,))
    want = jeng.generate(PROMPTS, frames=frames,
                         gen=JaxGenerationConfig(max_new_tokens=NEW_TOKENS),
                         eos_token_id=-1)
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    got = eng.generate(PROMPTS, frames=frames,
                       gen=GenerationConfig(max_new_tokens=NEW_TOKENS),
                       eos_token_id=-1)
    assert got == want
    assert all(len(o) == NEW_TOKENS for o in got)

    plan = jsplice.plan_batch(PROMPTS, cfg.tokens_per_video, 64)
    ref = _first_logits_jax(cfg, jp, frames, plan, 64)
    port = _first_logits_port(cfg, tp, frames, plan, 64)
    atol = FP32_LOGIT_ATOL if wire_fmt == "float" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol)
    assert [o[0] for o in got] == list(ref.argmax(-1))


def test_text_and_shared_media_modes_match_jax(tiny):
    cfg, jp, tp = tiny
    frames = _videos(cfg, "rgb")[:1]
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,))
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    for kw in (dict(), dict(frames=frames, share_media=True)):
        prompts = PROMPTS if kw else [[1, 5, 9, 17, 4], [1, 33, 8]]
        want = jeng.generate(prompts, gen=JaxGenerationConfig(
            max_new_tokens=5), eos_token_id=-1, **kw)
        got = eng.generate(prompts, gen=GenerationConfig(max_new_tokens=5),
                           eos_token_id=-1, **kw)
        assert got == want


def test_decode_stops_at_eos_and_stop_fn(tiny):
    cfg, _, tp = tiny
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu", decode_chunk=3)
    free = eng.generate([[1, 5, 9]], gen=GenerationConfig(max_new_tokens=7),
                        eos_token_id=-1)[0]
    assert len(free) == 7
    eos = free[3]
    stop_at = free.index(eos) + 1
    got = eng.generate([[1, 5, 9]], gen=GenerationConfig(max_new_tokens=7),
                       eos_token_id=eos)[0]
    assert got == free[:stop_at]
    streamed = []
    got = eng.generate([[1, 5, 9]], gen=GenerationConfig(max_new_tokens=7),
                       eos_token_id=-1, stop_fn=lambda t: len(t) >= 4,
                       stream_cb=lambda b, t: streamed.append(list(t)))
    assert got[0] == free[:4] and streamed[-1] == free[:4]


def test_top_p_sampling_is_seeded(tiny):
    cfg, _, tp = tiny
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    gen = GenerationConfig(do_sample=True, temperature=1.0, top_p=0.9,
                           max_new_tokens=6, seed=3)
    a = eng.generate(PROMPTS[:1] * 2, frames=_videos(cfg, "rgb"), gen=gen,
                     eos_token_id=-1)
    b = eng.generate(PROMPTS[:1] * 2, frames=_videos(cfg, "rgb"), gen=gen,
                     eos_token_id=-1)
    assert a == b
    assert all(0 <= t < cfg.llm.vocab_size for row in a for t in row)


def test_sampled_request_ignores_speculative_k(tiny):
    """As in the JAX Engine, speculation is for greedy requests: a sampled
    one decodes plainly whatever speculative_k says, so its seeded tokens
    are those of speculative_k=0."""
    cfg, jp, tp = tiny
    frames = _videos(cfg, "rgb")
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    kw = dict(do_sample=True, temperature=1.0, top_p=0.9, max_new_tokens=6,
              seed=3)
    plain = eng.generate(PROMPTS, frames=frames,
                         gen=GenerationConfig(**kw), eos_token_id=-1)
    spec = eng.generate(PROMPTS, frames=frames,
                        gen=GenerationConfig(speculative_k=4, **kw),
                        eos_token_id=-1)
    assert spec == plain
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,))
    jout = jeng.generate(PROMPTS, frames=frames,
                         gen=JaxGenerationConfig(speculative_k=4, **kw),
                         eos_token_id=-1)
    assert [len(o) for o in jout] == [len(o) for o in spec] == [6, 6]


def test_unported_options_raise(tiny):
    cfg, _, tp = tiny
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    # this model has no audio branch (the AV model's: test_torch_audio.py)
    with pytest.raises(ValueError, match="audio branch"):
        eng.generate([[1, 2]], audio=np.zeros((1, 4, 128), np.float32))
    # grouped media (tests/test_torch_serve.py) checks its indices
    with pytest.raises(ValueError, match="media_group"):
        eng.generate([[1, 2]], frames=_videos(cfg, "rgb"), media_group=[2])
    with pytest.raises(ValueError):     # as the JAX Engine: 8 or 16 only
        Engine(cfg, tp, dtype=torch.float32, kv_bits=4, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(cfg, tp, dtype=torch.float32, device="cpu",
               shard_fn=lambda p: p)


def test_engine_without_a_device_needs_a_gpu(tiny, monkeypatch):
    """The default device is the GPU: without one the Engine raises
    instead of carrying on on the CPU."""
    cfg, _, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, tp, dtype=torch.float32)


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """The tiny model with int8 LLM packs (head included) and an int8
    tower, as the serving configuration quantizes it."""
    cfg, jp, _ = tiny
    jq = dict(jp, llm=jquant.quantize_llm_params(jp["llm"]),
              vision=jquant.quantize_vision_params(jp["vision"]))
    return cfg, jq, params_from_jax(jax.tree.map(np.asarray, jq), cfg)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_int8_slice_matches_jax_engine(tiny_int8, kv_bits):
    """The int8 serving path: W8A8 tower, prefill and head, decode on the
    layered kernels (plain versions here; Pallas in interpret mode in the
    JAX Engine, under force_native_quant so that it takes the W8A8 math the
    accelerator serves). Greedy tokens identical; the caches after
    generate compare one to one (int8 rows exactly; scales to 1e-5
    relative: a scale is its row's amax / 127, so it carries the fp32 noise
    of the k/v values, which differ by summation order through the tower,
    the connector and two layers, measured up to 1.6e-6 relative);
    first-token logits to FP32_LOGIT_ATOL.

    W8A8 rounds activations to int8, and fp32 activations that differ in
    the last bits between the packages round differently when they lie
    within ~1e-5 of a .5 boundary: with the other tests' frames (seed 11)
    a few tower activations do (the nearest at 3.8e-6), which moves some
    visual tokens' cache rows by one int8 step. These frames (seed 7) keep
    every W8A8 input at least 5.7e-6 from a boundary."""
    cfg, jq, tq = tiny_int8
    frames = _videos(cfg, "float", seed=7)
    gen_kw = dict(max_new_tokens=NEW_TOKENS)
    jeng = JaxEngine(cfg, jq, dtype=jnp.float32, max_len=128, buckets=(64,),
                     kv_bits=kv_bits)
    eng = Engine(cfg, tq, dtype=torch.float32, max_len=128, buckets=(64,),
                 kv_bits=kv_bits, device="cpu")
    assert eng.max_len == jeng.max_len == (256 if kv_bits == 8 else 128)
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

    plan = jsplice.plan_batch(PROMPTS, cfg.tokens_per_video, 64)
    with jlayers.force_native_quant(), jlayers.quant_inference(), \
            jlayers.w8a8_prefill():
        ref = _first_logits_jax(cfg, jeng.params, frames, plan, 64)
    port = _first_logits_port(cfg, eng.params, frames, plan, 64, w8a8=True)
    np.testing.assert_allclose(port, ref, rtol=0, atol=FP32_LOGIT_ATOL)
    assert [o[0] for o in got] == list(ref.argmax(-1))


@pytest.fixture(scope="module")
def tiny_int4(tiny):
    """The tiny model in the load_4bit serving layout: folded int4 LLM
    layers, an int8 head and an int8 tower (JAX's quantized_abstract with
    llm_bits=4 and quantize_vision)."""
    cfg, jp, _ = tiny
    jq = dict(jp, llm=jquant.quantize_llm_params(jp["llm"], bits=4),
              vision=jquant.quantize_vision_params(jp["vision"]))
    return cfg, jq, params_from_jax(jax.tree.map(np.asarray, jq), cfg)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_int4_slice_matches_jax_engine(tiny_int4, kv_bits):
    """The int4 serving path: W8A8 tower, W4A8 prefill, int8 head, decode
    on the int4 layered kernels (plain versions here; Pallas
    matmul_q4_layered / ffn_q4_layered in interpret mode in the JAX Engine,
    under force_native_quant). Greedy tokens identical; first-token logits
    to FP32_LOGIT_ATOL. Frames as in test_int8_slice_matches_jax_engine
    (seed 7), whose W8A8/W4A8 inputs stay clear of .5 boundaries here too
    (ROADMAP §3)."""
    cfg, jq, tq = tiny_int4
    frames = _videos(cfg, "float", seed=7)
    gen_kw = dict(max_new_tokens=NEW_TOKENS)
    jeng = JaxEngine(cfg, jq, dtype=jnp.float32, max_len=128, buckets=(64,),
                     kv_bits=kv_bits)
    eng = Engine(cfg, tq, dtype=torch.float32, max_len=128, buckets=(64,),
                 kv_bits=kv_bits, device="cpu")
    assert set(eng.params["llm"]["layers"]["qkv"]) == {"kernel_q4"}
    with jlayers.force_native_quant():
        want = jeng.generate(PROMPTS, frames=frames,
                             gen=JaxGenerationConfig(**gen_kw),
                             eos_token_id=-1)
    got = eng.generate(PROMPTS, frames=frames,
                       gen=GenerationConfig(**gen_kw), eos_token_id=-1)
    assert got == want

    plan = jsplice.plan_batch(PROMPTS, cfg.tokens_per_video, 64)
    with jlayers.force_native_quant(), jlayers.quant_inference(), \
            jlayers.w8a8_prefill():
        ref = _first_logits_jax(cfg, jeng.params, frames, plan, 64)
    port = _first_logits_port(cfg, eng.params, frames, plan, 64, w8a8=True)
    np.testing.assert_allclose(port, ref, rtol=0, atol=FP32_LOGIT_ATOL)
    assert [o[0] for o in got] == list(ref.argmax(-1))
