"""The port's speculative decoding against the JAX package: the K-slot
verify pass (models/llm.decode_verify) and the Engine's prompt-lookup
loops (B = 1 and batched), on the tiny config on the CPU.

decode_verify: the same seeded prompts and tokens go through JAX's
decode_verify and the port's; fp32 logits agree to 1e-4
(FP32_LOGIT_ATOL) and so do the caches (an int8 cache's rows exactly, its
scales to 1e-5 relative: a scale is its row's amax / 127 and carries the
fp32 noise of the k/v values). The port's verify logits also agree to
1e-4 with its own sequential decode_steps over the same tokens. With int8
packs the JAX side runs under force_native_quant and quant_inference, as
the JAX Engine verifies, so both take W8A8 up to 64 rows and dequantize
above.

Engine: speculative greedy tokens equal the port's plain greedy tokens
and the JAX Engine's speculative tokens, exactly, with two exceptions
that the tests pin: with int8 packs the verify pass's W8A8 products and
the plain decode's weight-only int8 kernels round apart, so a near-tie
may flip a token in both packages alike (assert_near_tie); and near the
end of the cache the JAX Engine's batched speculation leaves plain greedy
where the port does not (test_engine_speculative_eos_and_budget, ROADMAP
§3).
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
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.multimodal import splice as jsplice
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.inference import engine as tengine
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.models import llm as tllm

FP32_LOGIT_ATOL = 1e-4
BUCKET, MAX_LEN = 32, 64


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model()
    jp = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """int8 LLM packs (head included), q/k/v fused as the Engines fuse
    them."""
    cfg, jp, _ = tiny
    jllm_q = jquant.fuse_qkv(jquant.quantize_llm_params(jp["llm"]))
    jq = dict(jp, llm=jllm_q)
    return cfg, jq, params_from_jax(jax.tree.map(np.asarray, jq), cfg)


def _with_window(cfg, window):
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, sliding_window=window))


def _prompts(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, cfg.llm.vocab_size - 1,
                                          4 + 3 * b)] for b in range(B)]


def _prefill_both(cfg, jp, tp, prompts, kv_bits, w8a8):
    """Text prefill of the prompts into a cache of each package."""
    B = len(prompts)
    plan = jsplice.plan_batch(prompts, cfg.tokens_per_video, BUCKET)
    jcache = jllm.init_cache(cfg.llm, B, MAX_LEN, jnp.float32,
                             kv_bits=kv_bits)
    pos = jnp.broadcast_to(jnp.arange(BUCKET)[None], (B, BUCKET))
    with jlayers.force_native_quant(w8a8), jlayers.w8a8_prefill(w8a8):
        emb = jllm.embed_tokens(jp["llm"], jnp.asarray(plan.text_ids),
                                dtype=jnp.float32)
        _, jcache = jllm.prefill(jp["llm"], cfg.llm, emb, pos,
                                 jnp.asarray(plan.valid_len), jcache,
                                 attn_impl="xla")
    tcache = tllm.init_cache(cfg.llm, B, MAX_LEN, torch.float32,
                             kv_bits=kv_bits)
    with torch.inference_mode():
        emb = tllm.embed_tokens(tp["llm"],
                                torch.from_numpy(plan.text_ids).long(),
                                torch.float32)
        tllm.prefill(tp["llm"], cfg.llm, emb,
                     torch.arange(BUCKET, dtype=torch.int32).expand(
                         B, BUCKET),
                     torch.from_numpy(plan.valid_len), tcache, w8a8=w8a8)
    return plan.valid_len, jcache, tcache


def _verify_jax(cfg, jp, toks, jcache, valid, step0, w8a8):
    with jlayers.force_native_quant(w8a8), jlayers.quant_inference(w8a8):
        te = jllm.embed_tokens(jp["llm"], jnp.asarray(toks),
                               dtype=jnp.float32)
        logits, jcache = jllm.decode_verify(
            jp["llm"], cfg.llm, te, jcache, jnp.asarray(valid), BUCKET,
            jnp.asarray(step0, jnp.int32))
    return np.asarray(logits), jcache


def _verify_port(cfg, tp, toks, tcache, valid, step0, w8a8):
    with torch.inference_mode():
        te = tllm.embed_tokens(tp["llm"], torch.tensor(toks), torch.float32)
        step = (torch.tensor(step0) if isinstance(step0, list) else step0)
        logits, tcache = tllm.decode_verify(
            tp["llm"], cfg.llm, te, tcache, torch.from_numpy(valid), BUCKET,
            step, w8a8=w8a8)
    return logits.numpy(), tcache


def _assert_caches_match(tcache, jcache):
    if tcache.quantized:
        for name in ("k", "v"):
            np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                          np.asarray(getattr(jcache, name)))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                       np.asarray(getattr(jcache, name)),
                                       rtol=1e-5, atol=0)
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                       np.asarray(getattr(jcache, name)),
                                       rtol=0, atol=FP32_LOGIT_ATOL)


def _sequential_port(cfg, tp, rows, tcache, valid):
    """Each row's tokens through the port's decode_step one at a time, row
    by row on its own slice of the cache (decode_step is lockstep).
    rows: per row, (tokens, index of the first one to keep logits of)."""
    out = []
    with torch.inference_mode():
        for b, (toks, keep) in enumerate(rows):
            sub = tllm.KVCache(*(None if t is None else t[:, b:b + 1].clone()
                                 for t in (tcache.k, tcache.v,
                                           tcache.k_scale, tcache.v_scale)))
            logits = []
            for i, t in enumerate(toks):
                te = tllm.embed_tokens(tp["llm"], torch.tensor([[t]]),
                                       torch.float32)
                lg, sub = tllm.decode_step(
                    tp["llm"], cfg.llm, te, sub,
                    torch.from_numpy(valid[b:b + 1]), BUCKET, i)
                if i >= keep:
                    logits.append(lg[0].numpy())
            out.append(np.stack(logits))
    return out


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_verify_matches_jax_and_sequential_steps(tiny, kv_bits,
                                                        window, per_row):
    """Two rows: a first verify pass of 3 slots at frontier 0, then a
    second of 4 slots at a scalar frontier 3 or at per-row frontiers
    [3, 1] (row 1 rewinds over two of its rows, as a row that accepted
    fewer drafts does). Logits of both passes and the caches after them
    match JAX; the second pass's logits match sequential decode_steps
    over each row's accepted tokens."""
    cfg, jp, tp = tiny
    cfg = _with_window(cfg, window)
    valid, jcache, tcache = _prefill_both(cfg, jp, tp, _prompts(cfg, 2, 3),
                                          kv_bits, False)
    rng = np.random.default_rng(4)
    first = rng.integers(3, cfg.llm.vocab_size - 1, (2, 3)).tolist()
    second = rng.integers(3, cfg.llm.vocab_size - 1, (2, 4)).tolist()
    step0 = [3, 1] if per_row else 3
    snapshot = tllm.KVCache(*(None if t is None else t.clone() for t in (
        tcache.k, tcache.v, tcache.k_scale, tcache.v_scale)))
    for toks, s0 in ((first, 0), (second, step0)):
        want, jcache = _verify_jax(cfg, jp, toks, jcache, valid, s0, False)
        got, tcache = _verify_port(cfg, tp, toks, tcache, valid, s0, False)
        assert got.shape == (2, len(toks[0]), cfg.llm.vocab_size)
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_LOGIT_ATOL)
        _assert_caches_match(tcache, jcache)
    starts = step0 if per_row else [step0, step0]
    seq = _sequential_port(
        cfg, tp, [(first[b][:starts[b]] + second[b], starts[b])
                  for b in range(2)], snapshot, valid)
    for b in range(2):
        np.testing.assert_allclose(got[b], seq[b], rtol=0,
                                   atol=FP32_LOGIT_ATOL, err_msg=f"row {b}")


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("B,K", [(8, 8), (8, 9)])
def test_decode_verify_int8_packs_across_the_w8a8_rows_limit(
        tiny_int8, kv_bits, B, K):
    """int8 fused-qkv packs at B * K = 64 rows (W8A8 in both packages) and
    72 rows (the dequantize branch in both): logits and caches match
    JAX's."""
    cfg, jq, tq = tiny_int8
    assert set(tq["llm"]["layers"]["qkv"]) == {"kernel_q8"}
    assert "qkv" in jq["llm"]["layers"]
    valid, jcache, tcache = _prefill_both(cfg, jq, tq, _prompts(cfg, B, 5),
                                          kv_bits, True)
    toks = np.random.default_rng(6).integers(
        3, cfg.llm.vocab_size - 1, (B, K)).tolist()
    w8a8 = B * K <= tengine.VERIFY_W8A8_ROWS
    want, jcache = _verify_jax(cfg, jq, toks, jcache, valid, 0, True)
    got, tcache = _verify_port(cfg, tq, toks, tcache, valid, 0, w8a8)
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_LOGIT_ATOL)
    _assert_caches_match(tcache, jcache)


def test_decode_verify_refuses_moe(tiny):
    cfg, _, tp = tiny
    moe = dataclasses.replace(cfg.llm, num_experts=4)
    cache = tllm.init_cache(cfg.llm, 1, MAX_LEN, torch.float32)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllm.decode_verify(tp["llm"], moe, torch.zeros(1, 2, 1), cache,
                           torch.tensor([3]), BUCKET, 0)


# -- the Engine ---------------------------------------------------------------

def _engines(cfg, jp, tp, max_len, **kw):
    return (JaxEngine(cfg, jp, dtype=jnp.float32, max_len=max_len,
                      buckets=(BUCKET,), attn_impl="xla", decode_chunk=4,
                      **kw),
            Engine(cfg, tp, dtype=torch.float32, max_len=max_len,
                   buckets=(BUCKET,), decode_chunk=4, device="cpu", **kw))


def _generate_all(jeng, eng, prompts, k, eos, frames=None, native=False,
                  **gen_kw):
    """(port plain, port speculative, JAX speculative) tokens."""
    plain = eng.generate(prompts, frames=frames,
                         gen=GenerationConfig(**gen_kw), eos_token_id=eos)
    got = eng.generate(prompts, frames=frames,
                       gen=GenerationConfig(speculative_k=k, **gen_kw),
                       eos_token_id=eos)
    with jlayers.force_native_quant(native):
        want = jeng.generate(
            prompts, frames=frames,
            gen=JaxGenerationConfig(speculative_k=k, **gen_kw),
            eos_token_id=eos)
    return plain, got, want


@pytest.mark.parametrize("k", [2, 4])
def test_engine_speculative_matches_plain_and_jax(tiny, k):
    """A video prompt at B = 1 (repetitive, so drafts are accepted) and
    three text prompts at B = 3 (batched speculation: one repetitive row,
    one whose drafts mostly miss, one of a single repeated token)."""
    cfg, jp, tp = tiny
    jeng, eng = _engines(cfg, jp, tp, 128)
    H = cfg.vision.image_size
    frames = np.random.default_rng(0).standard_normal(
        (1, cfg.num_frames, H, H, 3)).astype(np.float32)
    video = [[3, 4, VIDEO_TOKEN_INDEX, 5, 6, 5, 6, 5]]
    plain, got, want = _generate_all(jeng, eng, video, k, -1, frames,
                                     max_new_tokens=12)
    assert got == plain == want and len(got[0]) == 12
    text = [[3, 4, 5, 6, 5, 6, 5, 6], [9, 10, 11, 12, 13], [6, 6, 6, 6]]
    plain, got, want = _generate_all(jeng, eng, text, k, -1,
                                     max_new_tokens=12)
    assert got == plain == want


@pytest.mark.parametrize("prompts", [[[3, 4, 5, 6, 3, 4, 5]],
                                     [[3, 4, 5, 6, 5, 6, 5, 6],
                                      [9, 10, 11, 12, 13], [6, 6, 6, 6]]],
                         ids=["B1", "B3"])
def test_engine_speculative_eos_and_budget(tiny, prompts):
    """EOS (7) inside a round and a cache budget tail shorter than k: at
    max_len 37 only 5 rows follow the bucket, so B = 1 hands the tail to
    the plain loop and the batched loop ends on 1-slot rounds. The tokens
    equal plain greedy's in both packages.

    At max_len 64 with B = 3 the JAX Engine's batched speculation breaks
    that rule, and the port does not follow it there (ROADMAP §3): row 1
    rides along in 3-slot rounds without room for a block, JAX's
    dynamic_update_slice moves the block back over the row's committed
    rows, and once the row resumes on 1-slot rounds its last token
    differs from plain greedy's."""
    cfg, jp, tp = tiny
    for max_len, steps in ((37, 8), (64, 40)):
        jeng, eng = _engines(cfg, jp, tp, max_len)
        plain, got, want = _generate_all(jeng, eng, prompts, 3, 7,
                                         max_new_tokens=steps)
        jplain = jeng.generate(prompts, gen=JaxGenerationConfig(
            max_new_tokens=steps), eos_token_id=7)
        assert got == plain == jplain, f"max_len {max_len}"
        if max_len == 64 and len(prompts) == 3:
            assert want[0] == got[0] and want[2] == got[2]
            assert want[1][:-1] == got[1][:-1] != want[1]
        else:
            assert got == want, f"max_len {max_len}"


def assert_near_tie(eng, cfg, prompt, plain, spec):
    """Where the speculative tokens leave the plain ones, both paths'
    logits over the same prefix (the plain tokens before that position)
    differ by less than 0.4 of the logits' std, chip_smoke's bound, and
    the plain path's top-2 margin is below that difference: a near-tie
    that the verify pass's W8A8 products (activations rounded to int8 per
    row) and the plain decode's weight-only int8 kernels round apart."""
    p = next(i for i, (a, b) in enumerate(zip(plain, spec)) if a != b)
    assert p >= 1, "the first token comes from the shared prefill"
    params = eng.params["llm"]
    plan = jsplice.plan_batch([prompt], cfg.tokens_per_video, BUCKET)
    valid = torch.from_numpy(plan.valid_len)

    def prefilled():
        cache = tllm.init_cache(cfg.llm, 1, eng.max_len, torch.float32,
                                kv_bits=eng.kv_bits)
        emb = tllm.embed_tokens(params,
                                torch.from_numpy(plan.text_ids).long(),
                                torch.float32)
        tllm.prefill(params, cfg.llm, emb,
                     torch.arange(BUCKET, dtype=torch.int32)[None], valid,
                     cache, w8a8=True)
        return cache

    def embed(ids):
        return tllm.embed_tokens(params, torch.tensor([ids]), torch.float32)

    with torch.inference_mode():
        cache = prefilled()
        for step, t in enumerate(plain[:p]):
            plain_logits, cache = tllm.decode_step(
                params, cfg.llm, embed([t]), cache, valid, BUCKET, step,
                w8a8=True)
        spec_logits, _ = tllm.decode_verify(
            params, cfg.llm, embed(plain[:p]), prefilled(), valid, BUCKET, 0,
            w8a8=p <= tengine.VERIFY_W8A8_ROWS)
    plain_logits, spec_logits = plain_logits[0], spec_logits[0, -1]
    assert int(plain_logits.argmax()) == plain[p]
    assert int(spec_logits.argmax()) == spec[p]
    diff = (plain_logits - spec_logits).abs().max().item()
    top2 = plain_logits.topk(2).values
    assert diff <= 0.4 * plain_logits.std().item()
    assert (top2[0] - top2[1]).item() < diff


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("prompts", [[[3, 4, 5, 6, 3, 4, 5]],
                                     [[3, 4, 5, 6, 3, 4, 5], [8, 8, 9, 8]]],
                         ids=["B1", "B2"])
def test_engine_speculative_int8_fused_qkv(tiny, kv_bits, prompts):
    """The serving layout: int8 packs with q/k/v fused by the Engines, the
    verify passes on W8A8 (B * K <= 64), the plain loop on the layered
    int8 decode (plain versions here, Pallas in interpret mode in JAX
    under force_native_quant); EOS-free and with EOS. Speculative tokens
    equal JAX's. They equal plain greedy's up to the first near-tie of the
    two roundings (assert_near_tie): with the int8 cache the first decode
    step's top-2 margin is 2.9e-4 against a logit difference of 3.8e-3,
    in both packages alike."""
    cfg, jp, _ = tiny
    jq = dict(jp, llm=jquant.quantize_llm_params(jp["llm"]))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg)
    jeng, eng = _engines(cfg, jq, tq, 64, kv_bits=kv_bits)
    assert set(eng.params["llm"]["layers"]["qkv"]) == {"kernel_q8"}
    for eos in (-1, None):
        if eos is None:  # a token the model emits, so EOS lands mid-round
            eos = eng.generate(prompts, gen=GenerationConfig(
                max_new_tokens=4), eos_token_id=-1)[0][2]
        plain, got, want = _generate_all(jeng, eng, prompts, 3, eos,
                                         native=True, max_new_tokens=10)
        assert got == want, f"eos {eos}"
        for b, prompt in enumerate(prompts):
            if got[b] != plain[b]:
                assert_near_tie(eng, cfg, prompt, plain[b], got[b])
