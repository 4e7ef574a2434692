"""The port's audio-visual model (VideoLLaMA2.1-AV) against the JAX package
on the CPU: the fbank front end and the .wav reader (bit-equal copies), the
BEATs position buckets (integer-equal at S = 512, where the log branch
runs), BEATs and encode_audio (fp32, 1e-4; 1e-3 at the released width),
the Engine's "av" and "audio" prefills with the shared decode, sessions
and speculation after them (fp32 first-token logits to 1e-4 and equal
tokens; int8 packs with an int8 cache: equal tokens), the BEATs checkpoint
mapper, and the public API on one tiny AV checkpoint directory (a tiny
Mistral model with the released BEATs and projector keys).

JAX runs at jax_default_matmul_precision="highest" (XLA-CPU's default
matmuls round their inputs). Params cross with params_from_jax.
"""

import json
import os
import sys
import warnings
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import videollama2_tpu
from videollama2_tpu.checkpoint import convert_hf as jconv
from videollama2_tpu.constants import AUDIO_TOKEN_INDEX, VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as jcfglib
from videollama2_tpu.core.config import AudioConfig
from videollama2_tpu.inference import api as japi
from videollama2_tpu.inference import sampling as jsampling
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.media import audio as jaudio
from videollama2_tpu.models import beats as jbeats
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
import videollama2_tpu_torch
from videollama2_tpu_torch.checkpoint import convert_hf as tconv
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.core import config as tcfglib
from videollama2_tpu_torch.inference import api as tapi
from videollama2_tpu_torch.inference import sampling as tsampling
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.media import audio as taudio
from videollama2_tpu_torch.models import beats as tbeats
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.ops import layers as tlayers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
FP32_ATOL = 1e-4
RELEASED_WIDTH_ATOL = 1e-3
NEW_TOKENS = 6
# tests/test_audio.py's tiny BEATs: S = 32 tokens, every bucket exact
TINY_AUDIO = AudioConfig(embed_dim=24, encoder_dim=32, num_layers=2,
                         num_heads=4, intermediate_size=64, conv_pos=8,
                         conv_pos_groups=4, max_frames=64)
AV_PROMPTS = [[1, 3, VIDEO_TOKEN_INDEX, AUDIO_TOKEN_INDEX, 5],
              [1, 7, 8, VIDEO_TOKEN_INDEX, AUDIO_TOKEN_INDEX, 5, 9, 11, 4]]
AUDIO_PROMPTS = [[1, 3, AUDIO_TOKEN_INDEX, 5],
                 [1, 7, 8, AUDIO_TOKEN_INDEX, 5, 9, 11, 4, 6]]


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# -- the front end ---------------------------------------------------------------

@pytest.mark.parametrize("seconds", [1.0, 3.7, 10.24])
def test_fbank_copy_matches_jax(seconds):
    rng = np.random.default_rng(int(seconds * 100))
    wav = (0.3 * rng.standard_normal(int(16000 * seconds))).clip(-1, 1)
    wav = wav.astype(np.float32)
    for fn in ("fbank", "beats_preprocess"):
        got, want = getattr(taudio, fn)(wav), getattr(jaudio, fn)(wav)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(taudio.mel_banks(128, 512, 16000),
                                  jaudio.mel_banks(128, 512, 16000))
    for name in ("SAMPLE_RATE", "FBANK_MEAN", "FBANK_STD"):
        assert getattr(taudio, name) == getattr(jaudio, name)


def _write_wav(path, rate, channels, width, seed):
    rng = np.random.default_rng(seed)
    n = int(rate * 1.3)
    if width == 2:
        data = rng.integers(-20000, 20000, (n, channels), dtype=np.int16)
    else:
        data = rng.integers(0, 256, (n, channels), dtype=np.uint8)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())
    return str(path)


@pytest.mark.parametrize("rate,channels,width", [(44100, 2, 2),
                                                 (16000, 1, 1)])
def test_load_wav_matches_jax(tmp_path, rate, channels, width):
    path = _write_wav(tmp_path / "a.wav", rate, channels, width, seed=rate)
    got = taudio.load_audio(path)
    want = jaudio.load_audio(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.shape == (int(int(rate * 1.3) * 16000 / rate),)


def test_container_audio_raises():
    """Container audio goes through the decoder (its track against JAX's:
    tests/test_torch_media.py); a missing file raises as in JAX."""
    with pytest.raises(OSError, match="no decodable audio"):
        taudio.load_audio("clip.mp4")
    with pytest.raises(OSError, match="no decodable audio"):
        jaudio.load_audio("clip.mp4")


# -- BEATs -------------------------------------------------------------------

def test_relative_position_buckets_at_512():
    """At S = 512 offsets reach 511: the log branch (distances >= 80) runs
    and the buckets are integer-equal to JAX's; the bias gathers them."""
    S = 512
    pos = np.arange(S)
    want = np.asarray(jbeats.relative_position_bucket(
        jnp.asarray(pos[None, :] - pos[:, None])))
    tpos = torch.arange(S)
    got = tbeats.relative_position_bucket(tpos[None, :] - tpos[:, None])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 304 and (np.abs(pos[None, :] - pos[:, None])
                                  >= 80).any()
    rel = np.random.default_rng(0).standard_normal((320, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tbeats.compute_position_bias(torch.from_numpy(rel), S).numpy(),
        np.asarray(jbeats.compute_position_bias(jnp.asarray(rel), S)))


def _beats_case(cfg, seed, B):
    jp = jbeats.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        # non-trivial biases, norm scales and gate constants
        a = np.asarray(a)
        if path[-1].key in ("bias", "scale", "grep_a"):
            a = a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        return a
    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    fb = rng.standard_normal((B, cfg.max_frames, 128)).astype(np.float32)
    return jp, fb


@pytest.mark.parametrize("cfg,atol", [
    (TINY_AUDIO, FP32_ATOL),
    # the released widths with one layer: S = 512, log buckets included
    (AudioConfig(num_layers=1), RELEASED_WIDTH_ATOL)],
    ids=["tiny", "released_width"])
def test_beats_forward_matches_jax(cfg, atol):
    jp, fb = _beats_case(cfg, seed=1, B=2 if cfg.num_layers > 1 else 1)
    want = np.asarray(jbeats.forward(jp, cfg, jnp.asarray(fb)))
    with torch.inference_mode():
        got = tbeats.forward(_tree(jp), cfg, torch.from_numpy(fb)).numpy()
    assert got.shape == want.shape == (fb.shape[0], cfg.tokens,
                                       cfg.encoder_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def tiny_av():
    cfg = jcfglib.tiny_model().replace(audio=TINY_AUDIO)
    jp = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _fbank(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.audio.max_frames, 128)).astype(
        np.float32)


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    T, H = cfg.num_frames, cfg.vision.image_size
    return rng.standard_normal((B, T, H, H, 3)).astype(np.float32)


def test_encode_audio_matches_jax(tiny_av):
    cfg, jp, tp = tiny_av
    fb = _fbank(cfg, 2, seed=3)
    want = np.asarray(jvl2.encode_audio(jp, cfg, jnp.asarray(fb)))
    with torch.inference_mode():
        got = tvl2.encode_audio(tp, cfg, torch.from_numpy(fb)).numpy()
    assert got.shape == (2, cfg.tokens_per_audio, cfg.llm.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_param_shapes_and_synthetic_audio_branch(tiny_av):
    from videollama2_tpu_torch.utils.synthetic import synthetic_params
    cfg, _, tp = tiny_av
    shapes = tvl2.param_shapes(cfg)
    assert set(shapes) == {"llm", "vision", "connector", "audio"}
    packed = tvl2.param_shapes(cfg, llm_bits=8, int8_vision=True)
    assert packed["audio"] == shapes["audio"]
    sp = synthetic_params(cfg, dtype=torch.float32, device="cpu", seed=0,
                          llm_bits=8)
    got = {p: tuple(t.shape) for p, t in _flat(sp["audio"])}
    assert got == {p: tuple(s) for p, s in _flat(shapes["audio"])}
    assert torch.equal(sp["audio"]["encoder"]["layers"]["grep_a"],
                       torch.ones_like(tp["audio"]["encoder"]["layers"]
                                       ["grep_a"]))
    assert all(t.dtype == torch.float32 for _, t in _flat(sp["audio"]))


# -- the Engine ------------------------------------------------------------------

class FirstLogits:
    """Records the logits of each package's first select_token call of a
    generate: the prefill's (JAX's decode steps run inside its jitted
    chunks, so only the prefill's call is concrete)."""

    def __init__(self, monkeypatch):
        self.got = {}
        for name, module in (("jax", jsampling), ("port", tsampling)):
            monkeypatch.setattr(module, "select_token",
                                self._wrap(name, module.select_token))

    def _wrap(self, name, fn):
        def select_token(key, logits, *args):
            if name not in self.got:
                self.got[name] = np.asarray(logits)
            return fn(key, logits, *args)
        return select_token


def _generate_both(cfg, jp, tp, mode, monkeypatch, kv_bits=16, seed=5,
                   **gen):
    frames = _frames(cfg, 2, seed) if mode == "av" else None
    audio = _fbank(cfg, 2, seed + 1)
    prompts = AV_PROMPTS if mode == "av" else AUDIO_PROMPTS
    tap = FirstLogits(monkeypatch)
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,),
                     kv_bits=kv_bits, decode_chunk=4)
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 kv_bits=kv_bits, decode_chunk=4, device="cpu")
    kw = dict(frames=frames, audio=audio, eos_token_id=-1)
    with jlayers.force_native_quant():
        want = jeng.generate(prompts, gen=JaxGenerationConfig(
            max_new_tokens=NEW_TOKENS, **gen), **kw)
    got = eng.generate(prompts, gen=GenerationConfig(
        max_new_tokens=NEW_TOKENS, **gen), **kw)
    return got, want, tap.got


@pytest.mark.parametrize("mode", ["av", "audio"])
def test_engine_matches_jax(tiny_av, mode, monkeypatch):
    """fp32 frames and fbank, B = 2 prompts of different lengths."""
    cfg, jp, tp = tiny_av
    got, want, logits = _generate_both(cfg, jp, tp, mode, monkeypatch)
    assert got == want
    assert all(len(o) == NEW_TOKENS for o in got)
    assert logits["port"].shape == (2, cfg.llm.vocab_size)
    np.testing.assert_allclose(logits["port"], logits["jax"], rtol=0,
                               atol=FP32_ATOL)


@pytest.fixture(scope="module")
def tiny_av_int8(tiny_av):
    cfg, jp, _ = tiny_av
    jq = dict(jp, llm=jquant.quantize_llm_params(jp["llm"]),
              vision=jquant.quantize_vision_params(jp["vision"]))
    return cfg, jq, params_from_jax(jax.tree.map(np.asarray, jq), cfg)


class W8A8Margin:
    """The least distance of any W8A8 activation of the port (x / scale)
    from a rounding boundary (.5) over a run: an activation that lies
    within the packages' fp32 noise of one may round to the other int8
    step in the other package."""

    def __init__(self, monkeypatch):
        self.least = np.inf
        quantize = tlayers._quantize_rows

        def recording(x):
            xq, xs = quantize(x)
            frac = torch.abs(x.float() / xs) % 1.0
            self.least = min(self.least,
                             (frac - 0.5).abs().min().item())
            return xq, xs
        monkeypatch.setattr(tlayers, "_quantize_rows", recording)


@pytest.mark.parametrize("mode", ["av", "audio"])
def test_int8_engine_matches_jax(tiny_av_int8, mode, monkeypatch):
    """int8 LLM and tower packs (W8A8 prefill and decode, the plain
    versions of the layered decode kernels here, Pallas in interpret mode
    under force_native_quant on the JAX side), an int8 KV cache and a
    floating audio branch: equal tokens. As in
    test_int8_slice_matches_jax_engine, the inputs keep every W8A8
    activation at least 5e-6 from a .5 boundary (checked), where fp32
    noise between the packages cannot move a rounding."""
    cfg, jq, tq = tiny_av_int8
    margin = W8A8Margin(monkeypatch)
    got, want, logits = _generate_both(cfg, jq, tq, mode, monkeypatch,
                                       kv_bits=8, seed=4)
    assert margin.least >= 5e-6
    assert got == want
    np.testing.assert_allclose(logits["port"], logits["jax"], rtol=0,
                               atol=FP32_ATOL)


@pytest.mark.parametrize("mode", ["av", "audio"])
def test_session_and_speculation_after_audio_prefill(tiny_av, mode):
    """A session from an AV (or audio) prompt continued by
    generate_continue equals JAX's continuation and a fresh generate over
    the whole history; speculative decoding after the same prefill gives
    plain greedy's tokens."""
    cfg, jp, tp = tiny_av
    frames = _frames(cfg, 1, 9) if mode == "av" else None
    audio = _fbank(cfg, 1, 10)
    prompt = AV_PROMPTS[1] if mode == "av" else AUDIO_PROMPTS[1]
    kw = dict(frames=frames, audio=audio, eos_token_id=-1)
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,),
                     attn_impl="xla", decode_chunk=4)
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 decode_chunk=4, device="cpu")
    g = dict(max_new_tokens=5)
    got, sess = eng.generate([prompt], gen=GenerationConfig(**g),
                             return_session=True, **kw)
    want, jsess = jeng.generate([prompt], gen=JaxGenerationConfig(**g),
                                return_session=True, **kw)
    assert got == want
    assert (sess.steps_done, sess.last_token, sess.token_history) == (
        jsess.steps_done, jsess.last_token, jsess.token_history)
    turn = [9, 10, 11, 9, 10]
    got2, _ = eng.generate_continue(sess, turn, gen=GenerationConfig(**g),
                                    eos_token_id=-1)
    want2, _ = jeng.generate_continue(jsess, turn,
                                      gen=JaxGenerationConfig(**g),
                                      eos_token_id=-1)
    assert got2 == want2
    fresh = eng.generate([prompt + got[0] + turn], gen=GenerationConfig(**g),
                         **kw)
    assert got2 == fresh
    plain = eng.generate([prompt], gen=GenerationConfig(max_new_tokens=12),
                         **kw)
    spec = eng.generate([prompt], gen=GenerationConfig(
        max_new_tokens=12, speculative_k=4), **kw)
    assert spec == plain


def test_audio_on_a_model_without_audio_raises(tiny_av):
    cfg, _, tp = tiny_av
    video_cfg = cfg.replace(audio=None)
    tp = {k: v for k, v in tp.items() if k != "audio"}
    eng = Engine(video_cfg, tp, dtype=torch.float32, max_len=128,
                 buckets=(64,), device="cpu")
    with pytest.raises(ValueError, match="audio branch"):
        eng.generate(AUDIO_PROMPTS, audio=_fbank(cfg, 2, 0))


# -- the checkpoint mapper -------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _beats_state_dict(cfg, prefix, seed):
    """A seeded state dict in the BEATs layout at cfg's widths."""
    D, E, F_, H = (cfg.encoder_dim, cfg.embed_dim, cfg.intermediate_size,
                   cfg.num_heads)
    K, G = cfg.conv_pos, cfg.conv_pos_groups
    shapes = {"patch_embedding.weight": (E, 1, 16, 16),
              "layer_norm.weight": (E,), "layer_norm.bias": (E,),
              "post_extract_proj.weight": (D, E),
              "post_extract_proj.bias": (D,),
              "encoder.pos_conv.0.weight_g": (1, 1, K),
              "encoder.pos_conv.0.weight_v": (D, D // G, K),
              "encoder.pos_conv.0.bias": (D,),
              "encoder.layer_norm.weight": (D,),
              "encoder.layer_norm.bias": (D,)}
    for l in range(cfg.num_layers):
        p = f"encoder.layers.{l}."
        for n in ("q_proj", "v_proj", "out_proj"):
            shapes[f"{p}self_attn.{n}.weight"] = (D, D)
            shapes[f"{p}self_attn.{n}.bias"] = (D,)
        shapes[f"{p}self_attn.k_proj.weight"] = (D, D)
        shapes[f"{p}self_attn.grep_linear.weight"] = (8, D // H)
        shapes[f"{p}self_attn.grep_linear.bias"] = (8,)
        shapes[f"{p}self_attn.gru_rel_pos_const"] = (1, H, 1, 1)
        shapes[f"{p}self_attn.relative_attention_bias.weight"] = (320, H)
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[f"{p}{n}.weight"] = (D,)
            shapes[f"{p}{n}.bias"] = (D,)
        shapes[f"{p}fc1.weight"], shapes[f"{p}fc1.bias"] = (F_, D), (F_,)
        shapes[f"{p}fc2.weight"], shapes[f"{p}fc2.bias"] = (D, F_), (D,)
    rng = np.random.default_rng(seed)
    return {prefix + k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("prefix", tconv.AUDIO_PREFIXES)
def test_audio_mapper_matches_jax(prefix):
    """audio_params_from_state_dict on a seeded BEATs state dict: every
    leaf equal to JAX's; the weight-normed pos-conv kernel within fp32
    summation noise (the norm's sum runs in another order)."""
    cfg = TINY_AUDIO
    sd = _beats_state_dict(cfg, prefix, seed=4)
    want = dict(_flat(jconv.audio_params_from_state_dict(sd, cfg, prefix)))
    got = dict(_flat(tconv.audio_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, prefix)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == np.shape(w) and g.dtype == np.float32, path
        if path == ("pos_conv", "kernel"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w)
    # the full tree through both loaders' AV branch, then params_from_jax
    mcfg = tcfglib.tiny_model().replace(audio=cfg)
    proj = {"model.mm_projector_a.0.weight": (64, cfg.encoder_dim),
            "model.mm_projector_a.0.bias": (64,),
            "model.mm_projector_a.2.weight": (64, 64),
            "model.mm_projector_a.2.bias": (64,)}
    rng = np.random.default_rng(5)
    sd.update({k: rng.standard_normal(s).astype(np.float32)
               for k, s in proj.items()})
    branch = tconv._audio_branch({k: torch.from_numpy(v)
                                  for k, v in sd.items()}, mcfg)
    np.testing.assert_array_equal(
        branch["projector"]["fc2"]["kernel"].numpy(),
        sd["model.mm_projector_a.2.weight"].T)


def test_missing_audio_tower_is_seeded_with_a_warning():
    cfg = tcfglib.tiny_model().replace(audio=TINY_AUDIO)
    with pytest.warns(UserWarning, match="no audio tower"):
        branch = tconv._audio_branch({}, cfg)
    got = {p: tuple(t.shape) for p, t in _flat(branch)}
    assert got == {p: tuple(s) for p, s in
                   _flat(tvl2.param_shapes(cfg)["audio"])}


# -- the public API on a tiny AV checkpoint --------------------------------------

def _write_audio_keys(ckpt, hidden):
    """Adds the released AV layout's audio keys (BEATs at its released
    widths, the projector to the tiny LLM's width) as a second shard, and
    the AV config key."""
    from safetensors.numpy import save_file
    with open(os.path.join(ROOT, "tests", "fixtures", "manifests",
                           "videollama2_1_7b_av.json")) as f:
        manifest = json.load(f)
    rng = np.random.default_rng(6)
    sd = {}
    for k, s in manifest.items():
        if not k.startswith(("model.audio_tower.", "model.mm_projector_a.")):
            continue
        if k.startswith("model.mm_projector_a."):
            s = [hidden, s[1] if s[1] == 768 else hidden] if len(s) == 2 \
                else [hidden]
        fan_in = s[1] if len(s) > 1 else 1
        if k.endswith("gru_rel_pos_const") or k.endswith("weight_g"):
            a = rng.uniform(0.5, 1.5, s)
        elif len(s) == 1 and k.endswith(".weight"):   # norm scales
            a = 1.0 + 0.1 * rng.standard_normal(s)
        elif len(s) == 1:                              # biases
            a = 0.02 * rng.standard_normal(s)
        else:
            a = rng.standard_normal(s) * (0.02 if "audio_tower" in k
                                          else fan_in ** -0.5)
        sd[k] = a.astype(np.float32)
    save_file(sd, os.path.join(ckpt, "model-audio.safetensors"))
    path = os.path.join(ckpt, "config.json")
    with open(path) as f:
        cfg_json = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(cfg_json, mm_audio_tower="BEATs_iter3_plus_AS2M"), f)
    return len(sd)


@pytest.fixture(scope="module")
def av_ckpt(tmp_path_factory):
    from make_tiny_checkpoint import build_checkpoint
    ckpt = build_checkpoint(str(tmp_path_factory.mktemp("av_ckpt")))
    assert _write_audio_keys(ckpt, hidden=64) == 242
    return ckpt


@pytest.fixture(scope="module")
def av_tokenizer(av_ckpt):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(av_ckpt, use_fast=True)


@pytest.fixture(scope="module")
def av_loaded(av_ckpt, av_tokenizer):
    kw = dict(max_len=1024, buckets=(768,))
    jax_side = videollama2_tpu.model_init(av_ckpt, dtype=jnp.float32,
                                          attn_impl="xla", **kw)
    port = videollama2_tpu_torch.model_init(
        av_ckpt, dtype=torch.float32, tokenizer=av_tokenizer, device="cpu",
        **kw)
    return jax_side, port


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    return _write_wav(tmp_path_factory.mktemp("wav") / "speech.wav", 44100,
                      2, 2, seed=8)


def _video(cfg, seed=0):
    return _frames(cfg, 1, seed)[0]


def test_av_checkpoint_loads_like_jax(av_ckpt, av_loaded):
    _, (tmodel, processor, _) = av_loaded
    cfg = tmodel.config
    assert cfg.audio == tcfglib.AudioConfig()
    assert set(processor) == {"image", "video", "audio", "av"}
    _, jtree = jconv.load_videollama2(av_ckpt)
    want = params_from_jax(jax.tree.map(np.asarray, jtree), cfg)
    got = dict(_flat(tmodel.engine.params))
    for path, w in _flat(want):
        if path == ("audio", "encoder", "pos_conv", "kernel"):
            np.testing.assert_allclose(got[path].numpy(), w.numpy(),
                                       rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(got[path], w), path


def test_mm_infer_audio_and_av_match_jax(av_loaded, wav_path):
    """mm_infer on a .wav (44.1 kHz stereo int16: resampled and downmixed)
    and on {"video": fp32 frames, "audio": the .wav}: the JAX package's
    answers."""
    (jmodel, _, jtok), (tmodel, processor, ttok) = av_loaded
    video = _video(tmodel.config)
    for modal, media in (("audio", wav_path),
                         ("av", {"video": video, "audio": wav_path})):
        want = japi.mm_infer(media, "What do you hear ?", jmodel, jtok,
                             modal=modal, max_new_tokens=NEW_TOKENS)
        got = tapi.mm_infer(media, "What do you hear ?", tmodel, ttok,
                            modal=modal, max_new_tokens=NEW_TOKENS)
        assert got == want and got
    feats = processor["audio"](wav_path)
    assert feats.shape == (1, 1024, 128)
    assert tapi.mm_infer(feats, "What do you hear ?", tmodel, ttok,
                         modal="audio", max_new_tokens=NEW_TOKENS) == \
        tapi.mm_infer(wav_path, "What do you hear ?", tmodel, ttok,
                      modal="audio", max_new_tokens=NEW_TOKENS)


def test_mm_infer_session_av_matches_stateless(av_loaded, wav_path):
    """Two mm_infer_session AV calls through one SessionStore: a miss,
    then a hit whose answer equals stateless mm_infer's and JAX's."""
    (jmodel, _, jtok), (tmodel, _, ttok) = av_loaded
    media = {"video": _video(tmodel.config, seed=2), "audio": wav_path}
    assert tapi.SessionStore.media_digest(media) == \
        japi.SessionStore.media_digest(media)
    store = tapi.SessionStore()
    turn1 = [{"role": "user", "content": "What sound ?"}]
    a1 = tapi.mm_infer_session(media, turn1, tmodel, ttok, store,
                               modal="av", max_new_tokens=4)
    assert store.stats == {"hits": 0, "misses": 1}
    turn2 = turn1 + [{"role": "assistant", "content": a1},
                     {"role": "user", "content": "why ?"}]
    a2 = tapi.mm_infer_session(media, turn2, tmodel, ttok, store,
                               modal="av", max_new_tokens=4)
    assert store.stats == {"hits": 1, "misses": 1}
    assert a2 == tapi.mm_infer(media, turn2, tmodel, ttok, modal="av",
                               max_new_tokens=4)
    assert a2 == japi.mm_infer(media, turn2, jmodel, jtok, modal="av",
                               max_new_tokens=4)


def test_chat_session_audio(av_loaded, wav_path):
    """ChatSession on a .wav: turn 2 from the cache, replies those of
    per-turn mm_infer."""
    _, (tmodel, _, ttok) = av_loaded
    chat = tapi.ChatSession(wav_path, tmodel, ttok, modal="audio",
                            max_new_tokens=4)
    msgs = []
    for q in ("What sound ?", "why ?"):
        reply = chat.ask(q)
        msgs.append({"role": "user", "content": q})
        assert reply == tapi.mm_infer(wav_path, [dict(m) for m in msgs],
                                      tmodel, ttok, modal="audio",
                                      max_new_tokens=4)
        msgs.append({"role": "assistant", "content": reply})
    assert chat.stats == {"cached_turns": 1, "fresh_turns": 1}


def test_container_paths_raise(av_loaded):
    """Container audio and AV on a missing file raise (the decoder cannot
    open it; tests/test_torch_serve.py answers real containers), and
    nothing degrades to silence."""
    _, (tmodel, processor, ttok) = av_loaded
    for call in (lambda: processor["av"]("clip.mp4"),
                 lambda: processor["audio"]("clip.mp4"),
                 lambda: tapi.mm_infer("clip.mp4", "hi", tmodel, ttok,
                                       modal="av"),
                 lambda: tapi.mm_infer("clip.mp4", "hi", tmodel, ttok,
                                       modal="audio"),
                 lambda: tapi.ChatSession("clip.mp4", tmodel, ttok,
                                          modal="av"),
                 lambda: tapi.mm_infer_session("clip.mp4", "hi", tmodel,
                                               ttok, tapi.SessionStore(),
                                               modal="av")):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(OSError, match="cannot open video|no "
                               "decodable audio"):
                call()
    with pytest.raises(ValueError, match="Unsupported modal"):
        tapi.mm_infer_batch(np.zeros((1, 4), np.float32), ["hi"], tmodel,
                            ttok, modal="audio")


def test_av_container_matches_jax(av_loaded, tmp_path):
    """A container with its own audio track through processor["av"] and
    through mm_infer(modal="av") on its path gives JAX's frames, features
    and answer; a container without an audio track answers with silence in
    both packages. The frames are written at the tower's size, so neither
    package resizes and both see the same pixels (the resize's tolerance
    is held in tests/test_torch_media.py)."""
    from avi_writer import write_avi
    (jmodel, jproc, jtok), (tmodel, processor, ttok) = av_loaded
    S = tmodel.config.vision.image_size
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, (6, S, S, 3), dtype=np.uint8)
    av, silent = str(tmp_path / "av.avi"), str(tmp_path / "silent.avi")
    write_avi(av, frames, rng.uniform(-0.5, 0.5, 16000 * 3), fps=2)
    write_avi(silent, frames, None, fps=2)
    got, want = processor["av"](av), jproc["av"](av)
    np.testing.assert_array_equal(got["video"], want["video"])
    np.testing.assert_array_equal(got["audio"], want["audio"])
    assert got["audio"].any()
    for path in (av, silent):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = japi.mm_infer(path, "What do you hear ?", jmodel, jtok,
                                 modal="av", max_new_tokens=NEW_TOKENS)
            got = tapi.mm_infer(path, "What do you hear ?", tmodel, ttok,
                                modal="av", max_new_tokens=NEW_TOKENS)
        assert got == want and got


def test_load_8bit_leaves_audio_unpacked(av_ckpt, av_tokenizer, wav_path):
    model, _, tok = videollama2_tpu_torch.model_init(
        av_ckpt, dtype=torch.float32, max_len=1024, buckets=(768,),
        load_8bit=True, kv_bits=8, tokenizer=av_tokenizer, device="cpu")
    params = model.engine.params
    assert "kernel_q8" in params["llm"]["layers"]["qkv"]
    assert "kernel_q8" in params["vision"]["layers"]["qkv"]
    leaves = dict(_flat(params["audio"]))
    assert set(leaves) == {p for p, _ in _flat(
        tvl2.param_shapes(model.config)["audio"])}
    assert all(t.dtype == torch.float32 for t in leaves.values())
    answer = tapi.mm_infer(wav_path, "What do you hear ?", model, tok,
                           modal="audio", max_new_tokens=4)
    assert isinstance(answer, str) and answer
