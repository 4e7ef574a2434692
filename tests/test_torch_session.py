"""The port's prefix-cached sessions against the JAX package: Session and
Engine.generate_continue, and the chat API on them (ChatSession,
SessionStore, mm_infer_session), on the tiny config on the CPU.

A continued turn feeds only its new tokens through verify passes into the
session's cache; its tokens must equal, exactly, those of a fresh
generate over the whole history (the port's) and those of the JAX
Engine's continuation of the same session. The chat API goes through
scripts/make_tiny_checkpoint.py's checkpoint and its tokenizer: replies
equal JAX's and per-turn mm_infer's, with turns served from the cache.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import videollama2_tpu
from videollama2_tpu.constants import VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.inference import api as japi
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
import videollama2_tpu_torch
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.inference import api as tapi
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model()
    jp = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _frames(cfg, seed=0):
    T, H = cfg.num_frames, cfg.vision.image_size
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, T, H, H, 3)).astype(np.float32)


def _engines(cfg, jp, tp, max_len, bucket, **kw):
    return (JaxEngine(cfg, jp, dtype=jnp.float32, max_len=max_len,
                      buckets=(bucket,), attn_impl="xla", decode_chunk=4,
                      **kw),
            Engine(cfg, tp, dtype=torch.float32, max_len=max_len,
                   buckets=(bucket,), decode_chunk=4, device="cpu", **kw))


def _conversation(jeng, eng, prompt, turns, gens, eos, frames=None):
    """One session through both Engines: the first turn by generate with
    return_session, the others by generate_continue. Returns the port's
    replies and session, after checking each reply against JAX's and the
    sessions' bookkeeping against each other."""
    kw = dict(frames=frames, eos_token_id=eos, return_session=True)
    got, sess = eng.generate([prompt], gen=GenerationConfig(**gens[0]), **kw)
    want, jsess = jeng.generate([prompt], gen=JaxGenerationConfig(**gens[0]),
                                **kw)
    replies = [got[0]]
    for turn, g in zip(turns, gens[1:]):
        assert got == want
        assert (sess.steps_done, sess.last_token, sess.token_history) == (
            jsess.steps_done, jsess.last_token, jsess.token_history)
        got, sess = eng.generate_continue(sess, turn,
                                          gen=GenerationConfig(**g),
                                          eos_token_id=eos)
        want, jsess = jeng.generate_continue(
            jsess, turn, gen=JaxGenerationConfig(**g), eos_token_id=eos)
        replies.append(got[0])
    assert got == want
    assert sess.token_history == jsess.token_history
    return replies, sess


def test_session_continue_matches_fresh_and_jax(tiny):
    cfg, jp, tp = tiny
    frames = _frames(cfg)
    prompt1 = [3, 4, VIDEO_TOKEN_INDEX, 5, 6]
    turn2 = [9, 10, 11]
    jeng, eng = _engines(cfg, jp, tp, 128, 64)
    (ans1, ans2), sess = _conversation(
        jeng, eng, prompt1, [turn2],
        [dict(max_new_tokens=5), dict(max_new_tokens=6)], -1, frames)
    assert len(ans1) == 5 and len(ans2) == 6
    assert sess.steps_done == 4 + len(turn2) + 1 + 5
    fresh = eng.generate([prompt1 + ans1 + turn2], frames=frames,
                         gen=GenerationConfig(max_new_tokens=6),
                         eos_token_id=-1)[0]
    assert ans2 == fresh
    assert sess.token_history == prompt1 + ans1 + turn2 + ans2


def test_session_three_turns_and_speculative(tiny):
    """Three continued turns over a video, alternating plain and
    speculative (k = 3) decoding; the second turn's feed of 12 tokens is
    one verify pass of the port's where the JAX Engine takes 8 + 1 + 1 + 1
    + 1."""
    cfg, jp, tp = tiny
    frames = _frames(cfg, seed=3)
    prompt1 = [3, VIDEO_TOKEN_INDEX, 5, 6, 5, 6]
    turns = [[7, 8], [9, 5, 6, 5, 6, 5, 6, 5, 6, 7, 7], [5, 6]]
    g, gs = dict(max_new_tokens=4), dict(max_new_tokens=4, speculative_k=3)
    jeng, eng = _engines(cfg, jp, tp, 128, 64)
    replies, _ = _conversation(jeng, eng, prompt1, turns, [g, g, gs, g], -1,
                               frames)
    history = prompt1 + replies[0]
    for turn, reply in zip(turns, replies[1:]):
        fresh = eng.generate([history + turn], frames=frames,
                             gen=GenerationConfig(**g), eos_token_id=-1)[0]
        assert reply == fresh
        history += turn + reply


def test_session_text_only_and_eos(tiny):
    """A text session; EOS emitted mid-turn ends a continued turn as it
    ends a fresh one."""
    cfg, jp, tp = tiny
    prompt = [3, 4, 5, 6]
    g = dict(max_new_tokens=8)
    jeng, eng = _engines(cfg, jp, tp, 96, 32)
    (ans, ans2), _ = _conversation(jeng, eng, prompt, [[11, 12]], [g, g], 7)
    fresh = eng.generate([prompt + ans + [11, 12]],
                         gen=GenerationConfig(**g), eos_token_id=7)[0]
    assert ans2 == fresh


@pytest.mark.parametrize("spec_k", [0, 3])
def test_session_after_mid_chunk_eos(tiny, spec_k):
    """EOS inside a decode chunk (chunk 4) or a verify round (k = 3)
    leaves rows past the last emitted token; the session's frontier is the
    emitted count, so the next turn never attends them."""
    cfg, jp, tp = tiny
    prompt = [3, 4, 5, 6, 3, 4]
    jeng, eng = _engines(cfg, jp, tp, 96, 32)
    probe = eng.generate([prompt], gen=GenerationConfig(max_new_tokens=6),
                         eos_token_id=-1)[0]
    eos = probe[1]
    g = dict(max_new_tokens=6, speculative_k=spec_k)
    (ans, ans2), sess = _conversation(jeng, eng, prompt, [[9, 10]], [g, g],
                                      eos)
    assert ans[-1] == eos and len(ans) <= 3, "EOS is not mid-chunk"
    fresh = eng.generate([prompt + ans + [9, 10]],
                         gen=GenerationConfig(**g), eos_token_id=eos)[0]
    assert ans2 == fresh


def test_session_int8_packs_and_cache_match_jax(tiny):
    """The serving layout: int8 packs with fused q/k/v and the int8 cache;
    the feed's verify passes write quantized rows. Two continued turns
    (one speculative) give JAX's tokens (JAX under force_native_quant)."""
    cfg, jp, _ = tiny
    jq = dict(jp, llm=jquant.quantize_llm_params(jp["llm"]),
              vision=jquant.quantize_vision_params(jp["vision"]))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg)
    jeng, eng = _engines(cfg, jq, tq, 128, 64, kv_bits=8)
    g = dict(max_new_tokens=5)
    with jlayers.force_native_quant():
        replies, sess = _conversation(
            jeng, eng, [3, VIDEO_TOKEN_INDEX, 5, 6], [[7, 8, 9], [10, 11]],
            [g, g, dict(g, speculative_k=3)], -1, _frames(cfg, seed=7))
    assert [len(r) for r in replies] == [5, 5, 5]
    assert sess.cache.quantized


@pytest.mark.parametrize("packs", ["float", "int8"])
def test_session_long_turn_feeds_in_several_passes(tiny, packs):
    """A turn of 70 ids (a feed of 71) goes through two verify passes, of
    64 and 7 slots, where the JAX Engine takes 32 + 32 + 1 * 7: the tokens
    are JAX's and those of a fresh generate (int8: packs and cache, JAX
    under force_native_quant)."""
    cfg, jp, tp = tiny
    kw = {}
    if packs == "int8":
        jp = dict(jp, llm=jquant.quantize_llm_params(jp["llm"]))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
        kw = dict(kv_bits=8)
    jeng, eng = _engines(cfg, jp, tp, 256, 96, **kw)
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(3, 60, 6)]
    turn = [int(t) for t in rng.integers(3, 60, 70)]
    g = dict(max_new_tokens=4)
    passes = []
    verify = eng._verify
    eng._verify = lambda tokens, *a: passes.append(len(tokens[0])) or \
        verify(tokens, *a)
    with jlayers.force_native_quant():
        (ans, ans2), _ = _conversation(jeng, eng, prompt, [turn], [g, g], -1)
    assert passes == [64, 7]
    fresh = eng.generate([prompt + ans + turn], gen=GenerationConfig(**g),
                         eos_token_id=-1)[0]
    assert ans2 == fresh


def test_session_cache_exhaustion_raises(tiny):
    cfg, _, tp = tiny
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=40, buckets=(32,),
                 decode_chunk=4, device="cpu")
    _, sess = eng.generate([[3, 4, 5]],
                           gen=GenerationConfig(max_new_tokens=4),
                           eos_token_id=-1, return_session=True)
    with pytest.raises(ValueError, match="session cache exhausted"):
        eng.generate_continue(sess, list(range(3, 20)),
                              gen=GenerationConfig(max_new_tokens=4),
                              eos_token_id=-1)
    # a refused turn leaves the session usable
    ans, _ = eng.generate_continue(sess, [5],
                                   gen=GenerationConfig(max_new_tokens=2),
                                   eos_token_id=-1)
    assert len(ans[0]) == 2


def test_session_refuses_media_batches_and_reuse(tiny):
    cfg, _, tp = tiny
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=64, buckets=(32,),
                 decode_chunk=4, device="cpu")
    with pytest.raises(ValueError, match="batch-1"):
        eng.generate([[3, 4], [5, 6]], gen=GenerationConfig(max_new_tokens=2),
                     eos_token_id=-1, return_session=True)
    _, sess = eng.generate([[3, 4, 5]],
                           gen=GenerationConfig(max_new_tokens=2),
                           eos_token_id=-1, return_session=True)
    with pytest.raises(ValueError, match="text-only"):
        eng.generate_continue(sess, [VIDEO_TOKEN_INDEX, 4],
                              gen=GenerationConfig(max_new_tokens=2))
    eng.generate_continue(sess, [4], gen=GenerationConfig(max_new_tokens=2))
    # the cache was written in place: the session is used up
    assert sess.cache is None
    with pytest.raises(ValueError, match="continued already"):
        eng.generate_continue(sess, [4],
                              gen=GenerationConfig(max_new_tokens=2))


# -- the chat API over the tiny checkpoint's tokenizer ------------------------

@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_tiny_checkpoint import build_checkpoint
    from transformers import AutoTokenizer
    ckpt = build_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    jmodel, _, jtok = videollama2_tpu.model_init(
        ckpt, dtype=jnp.float32, max_len=256, buckets=(64, 192),
        attn_impl="xla")
    ttok = AutoTokenizer.from_pretrained(ckpt, use_fast=True)
    tmodel, _, ttok = videollama2_tpu_torch.model_init(
        ckpt, dtype=torch.float32, max_len=256, buckets=(64, 192),
        tokenizer=ttok, device="cpu")
    return (jmodel, jtok), (tmodel, ttok)


def _clip(cfg, seed=0):
    H = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal(
        (cfg.num_frames, H, H, 3)).astype(np.float32)


QUESTIONS = ("what is happening ?", "and after that ?", "why though ?")


@pytest.mark.parametrize("modal,spec_k", [("video", 0), ("image", 3),
                                          ("text", 0)])
def test_chat_session_matches_jax_and_mm_infer(loaded, modal, spec_k):
    """Three turns of a ChatSession: each reply equals the JAX
    ChatSession's and a stateless port mm_infer over the whole message
    history; the later turns come from the cache."""
    (jmodel, jtok), (tmodel, ttok) = loaded
    media = None if modal == "text" else _clip(tmodel.config)
    kw = dict(max_new_tokens=6, speculative_k=spec_k)
    chat = tapi.ChatSession(media, tmodel, ttok, modal=modal, **kw)
    jchat = japi.ChatSession(media, jmodel, jtok, modal=modal, **kw)
    msgs = []
    for q in QUESTIONS:
        reply = chat.ask(q)
        assert reply == jchat.ask(q)
        msgs.append({"role": "user", "content": q})
        ref = tapi.mm_infer(media, copy.deepcopy(msgs), tmodel, ttok,
                            modal=modal, **kw)
        assert reply == ref, f"turn {len(msgs)}"
        msgs.append({"role": "assistant", "content": reply})
    assert chat.stats == jchat.stats
    assert chat.stats["fresh_turns"] >= 1
    assert chat.stats["cached_turns"] >= 1, chat.stats


def test_mm_infer_session_matches_jax_and_mm_infer(loaded):
    """Stateless requests through one SessionStore: a growing
    conversation over one clip, then a request about another clip (a
    miss). Replies equal JAX's mm_infer_session and mm_infer; the store
    reports hits."""
    (jmodel, jtok), (tmodel, ttok) = loaded
    clips = [_clip(tmodel.config, seed) for seed in (1, 2)]
    store, jstore = tapi.SessionStore(), japi.SessionStore()
    msgs = []
    streamed = []
    for q in QUESTIONS[:2]:
        msgs.append({"role": "user", "content": q})
        reply = tapi.mm_infer_session(
            clips[0], copy.deepcopy(msgs), tmodel, ttok, store,
            max_new_tokens=6,
            stream_cb=lambda b, toks: streamed.append(list(toks)))
        assert reply == japi.mm_infer_session(
            clips[0], copy.deepcopy(msgs), jmodel, jtok, jstore,
            max_new_tokens=6)
        assert reply == tapi.mm_infer(clips[0], copy.deepcopy(msgs), tmodel,
                                      ttok, max_new_tokens=6)
        assert ttok.decode(streamed[-1], skip_special_tokens=True).strip() \
            == reply
        msgs.append({"role": "assistant", "content": reply})
    other = tapi.mm_infer_session(clips[1], QUESTIONS[0], tmodel, ttok,
                                  store, max_new_tokens=6)
    assert other == tapi.mm_infer(clips[1], QUESTIONS[0], tmodel, ttok,
                                  max_new_tokens=6)
    assert store.stats == {"hits": 1, "misses": 2}
    assert store.stats["hits"] == jstore.stats["hits"]


def test_session_api_refuses_audio(loaded):
    """On a model without the audio branch the audio and AV modals raise
    (the AV model's sessions: tests/test_torch_audio.py)."""
    _, (tmodel, ttok) = loaded
    for modal in ("audio", "av"):
        with pytest.raises(ValueError, match="audio-visual model"):
            tapi.ChatSession(None, tmodel, ttok, modal=modal)
        with pytest.raises(ValueError, match="audio-visual model"):
            tapi.mm_infer_session(None, "hi", tmodel, ttok,
                                  tapi.SessionStore(), modal=modal)
