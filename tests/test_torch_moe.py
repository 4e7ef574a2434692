"""The port's Mixtral MoE decoder against the JAX package, on the tiny
config (4 experts, top-2) in fp32 on the CPU, inputs from numpy seeds.

The router's expert indices must be equal and its weights within 1e-6;
the dense and the capacity-gather FFN within 1e-5 (the port runs the dense
dispatch one expert at a time and sums in another order than JAX's
einsums); forward / prefill / decode_step / decode logits within 1e-4;
Engine tokens (plain, speculative, a continued session turn) identical;
the `from_jax` bridge and the HF-layout mapper leaf for leaf equal; the
Trainer's loss and gradients within 1e-4. MoE runs on floating expert
kernels only: packed trees raise NotImplementedError naming MoE, which
the JAX package cannot run either (tests/test_torch_quant.py pins its
KeyError).
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import videollama2_tpu
from videollama2_tpu.checkpoint import convert_hf as jconv
from videollama2_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.train import data as jdata
from videollama2_tpu.train import lora as jlora
import videollama2_tpu_torch
from videollama2_tpu_torch.checkpoint import convert_hf as tconv
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.ops import quant as tquant
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import lora as tlora
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep
from videollama2_tpu_torch.utils.synthetic import synthetic_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFN_ATOL = 1e-5
FP32_LOGIT_ATOL = 1e-4
NEW_TOKENS = 8


def _jax_view(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The tiny VideoLLaMA2-8x7B layout: CLIP + STC + Mixtral (4 experts,
    top-2), JAX's params and the port's made from them."""
    cfg = cfglib.tiny_model("videollama2_mixtral",
                            projector_type="stc_connector")
    assert (cfg.llm.num_experts, cfg.llm.num_experts_per_tok) == (4, 2)
    jp = _jax_view(jvl2.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jp, params_from_jax(jp, cfg)


@pytest.fixture(scope="module")
def tiny_llm(tiny):
    """The decoder alone: its config and both packages' LLM trees."""
    cfg, jp, tp = tiny
    return cfg.llm, jp["llm"], tp["llm"]


def _layer0(params):
    return {n: {k: (v[0] if not isinstance(v, dict) else v)
                for k, v in e.items()}
            for n, e in params["layers"].items()}


def _tlayer0(params):
    return tllm.layer_params(params["layers"], 0)


def _x(cfg, B, S, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, cfg.hidden_size)) * scale).astype(np.float32)


# -- the router and the FFN ---------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_router_matches_jax(tiny_llm, ties):
    """Indices equal, weights within 1e-6. With `ties`, experts 1 and 2
    (and 0 and 3) have the same router column, so every token has exactly
    tied probabilities: both packages keep the lower index first."""
    cfg, jp, tp = tiny_llm
    jl, tl = _layer0(jp), _tlayer0(tp)
    if ties:
        w = np.array(jl["router"]["kernel"])
        w[:, 2], w[:, 3] = w[:, 1], w[:, 0]
        jl = dict(jl, router={"kernel": w})
        tl = dict(tl, router={"kernel": torch.from_numpy(w)})
    x = _x(cfg, 4, 32, seed=3)
    jw, ji = jllm._moe_router(jnp.asarray(x), jl, cfg)
    tw, ti = tllm._moe_router(torch.from_numpy(x), tl, cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    if ties:
        probs = np.asarray(jax.nn.softmax(
            jnp.asarray(x) @ jnp.asarray(jl["router"]["kernel"]), -1))
        assert np.array_equal(probs[..., 1], probs[..., 2])
        assert set(np.unique(np.asarray(ji)[..., 0])) <= {0, 1}


@pytest.mark.parametrize("mode,B,S", [("dense", 4, 32), ("gather", 4, 32),
                                      ("auto", 4, 16), ("auto", 1, 7)])
def test_ffn_moe_matches_jax(tiny_llm, mode, B, S):
    """Dense and gather at 128 tokens; "auto" at 64 tokens (gather in both)
    and at 7 (dense)."""
    cfg, jp, tp = tiny_llm
    cfg = dataclasses.replace(cfg, moe_dispatch=mode)
    x = _x(cfg, B, S, seed=4)
    want = np.asarray(jllm._ffn_moe(jnp.asarray(x), _layer0(jp), cfg))
    got = tllm._ffn_moe(torch.from_numpy(x), _tlayer0(tp), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_ATOL)


def test_gather_drops_match_jax(tiny_llm):
    """moe_capacity_factor 0.25 (JAX's tests/test_llm_parity.py): C = 4 of
    32 tokens' 64 pairs an expert, so most pairs are dropped. The outputs
    agree within 1e-5, and the tokens all of whose pairs were dropped
    (zero rows) are the same ones; the port's kept pairs are those JAX's
    rank rule keeps (computed here from JAX's routing)."""
    cfg, jp, tp = tiny_llm
    cfg = dataclasses.replace(cfg, moe_dispatch="gather",
                              moe_capacity_factor=0.25)
    x = _x(cfg, 2, 16, seed=2, scale=1.0)
    want = np.asarray(jllm._ffn_moe(jnp.asarray(x), _layer0(jp), cfg))
    got = tllm._ffn_moe(torch.from_numpy(x), _tlayer0(tp), cfg).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_ATOL)
    zero = lambda y: np.all(y.reshape(-1, y.shape[-1]) == 0, axis=-1)
    np.testing.assert_array_equal(zero(got), zero(want))
    _, ji = jllm._moe_router(jnp.asarray(x.reshape(-1, x.shape[-1])),
                             _layer0(jp), cfg)
    flat_e = np.asarray(ji).reshape(-1)
    N, E, k = 32, cfg.num_experts, cfg.num_experts_per_tok
    C = min(N, max(1, int(-(-N * k * cfg.moe_capacity_factor // E))))
    rank = np.array([np.sum(flat_e[:i] == e) for i, e in enumerate(flat_e)])
    slot, keep, c = tllm._capacity_slots(torch.from_numpy(flat_e.astype(np.int64)), N, cfg)
    assert c == C == 4
    np.testing.assert_array_equal(keep.numpy(), rank < C)
    np.testing.assert_array_equal(slot.numpy(), np.minimum(rank, C - 1))
    assert 0 < (~keep).sum().item() < N * k


# -- the decoder --------------------------------------------------------------

def _prefill_jax(cfg, jp, x, valid, M):
    B, S, _ = x.shape
    cache = jllm.init_cache(cfg, B, M, jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    last, cache = jllm.prefill(jp, cfg, jnp.asarray(x), pos,
                               jnp.asarray(valid), cache, attn_impl="xla")
    return np.asarray(jllm.lm_logits(jp, cfg, last)), cache


@pytest.mark.parametrize("mode", ["auto", "dense"])
def test_forward_prefill_decode_match_jax(tiny_llm, mode):
    """forward (with and without remat), prefill and 3 decode steps at
    B 2: prefill at 80 tokens takes the gather under "auto" in both
    packages, each decode step (2 tokens) the dense dispatch."""
    cfg, jp, tp = tiny_llm
    cfg = dataclasses.replace(cfg, moe_dispatch=mode)
    B, S, M = 2, 40, 48
    x = _x(cfg, B, S, seed=5, scale=1.0)
    valid = np.array([40, 29], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jh, _ = jllm.forward(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                         jnp.asarray(valid), attn_impl="xla")
    want = np.asarray(jllm.lm_logits(jp, cfg, jh))
    for remat in (False, True):
        with torch.no_grad():
            th = tllm.forward(tp, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()),
                              torch.from_numpy(valid), remat=remat)
            got = tllm.lm_logits(tp, cfg, th).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_LOGIT_ATOL)

    jlogits, jcache = _prefill_jax(cfg, jp, x, valid, M)
    tcache = tllm.init_cache(cfg, B, M, torch.float32)
    toks = np.random.default_rng(6).integers(3, cfg.vocab_size - 1, (3, B))
    with torch.inference_mode():
        last, _ = tllm.prefill(tp, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()),
                               torch.from_numpy(valid), tcache)
        np.testing.assert_allclose(tllm.lm_logits(tp, cfg, last).numpy(),
                                   jlogits, rtol=0, atol=FP32_LOGIT_ATOL)
        for s in range(3):
            te = tllm.embed_tokens(tp, torch.from_numpy(toks[s][:, None]),
                                   torch.float32)
            got, tcache = tllm.decode_step(tp, cfg, te, tcache,
                                           torch.from_numpy(valid), S, s)
            jte = jllm.embed_tokens(jp, jnp.asarray(toks[s][:, None]),
                                    dtype=jnp.float32)
            want, jcache = jllm.decode_step(jp, cfg, jte, jcache,
                                            jnp.asarray(valid), S,
                                            jnp.int32(s))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=FP32_LOGIT_ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_packed_moe_raises(tiny_llm, tiny, bits):
    """Packed expert stacks are refused wherever they could enter: the
    param layout, the synthetic tree, a forward or decode over packs
    (ops/quant packs the expert stacks as JAX's quantize_llm_params does),
    the Engine's first generate."""
    cfg, _, tp = tiny_llm
    with pytest.raises(NotImplementedError, match="MoE"):
        tllm.param_shapes(cfg, bits=bits)
    mcfg = tiny[0]
    with pytest.raises(NotImplementedError, match="MoE"):
        synthetic_params(mcfg, dtype=torch.float32, device="cpu",
                         llm_bits=bits)
    packed = tquant.quantize_llm_params(tp, bits=bits)
    assert "kernel_q%d" % bits in packed["layers"]["gate"]
    x = torch.zeros(1, 4, cfg.hidden_size)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllm.forward(packed, cfg, x, torch.zeros(1, 4, dtype=torch.int32),
                     torch.tensor([4]))
    with pytest.raises(NotImplementedError, match="MoE"):
        tllm.decode_step(packed, cfg, x[:, :1],
                         tllm.init_cache(cfg, 1, 8, torch.float32),
                         torch.tensor([4]), 4, 0)


# -- the Engine -----------------------------------------------------------------

def _videos(cfg, seed=11):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    mean = np.asarray(cfg.vision.image_mean, np.float32)
    std = np.asarray(cfg.vision.image_std, np.float32)
    rgb = rng.integers(0, 256, (2, T, H, H, 3), dtype=np.uint8)
    return ((rgb / np.float32(255.0) - mean) / std).astype(np.float32)


PROMPTS = [[1, 5, 9, VIDEO_TOKEN_INDEX, 17, 4, 5, 9, 17],
           [1, 33, VIDEO_TOKEN_INDEX, 8, 2, 6, 200, 7]]


def test_engine_moe_dispatch_override(tiny):
    """As the JAX Engine (its tests/test_engine.py): "auto" becomes
    "dense" in the Engine, an explicit "gather" is kept."""
    cfg, _, tp = tiny
    assert cfg.llm.is_moe and cfg.llm.moe_dispatch == "auto"
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    assert eng.cfg.llm.moe_dispatch == "dense"
    assert cfg.llm.moe_dispatch == "auto"            # the caller's is kept
    gcfg = cfg.replace(llm=dataclasses.replace(cfg.llm,
                                               moe_dispatch="gather"))
    eng_g = Engine(gcfg, tp, dtype=torch.float32, max_len=128,
                   buckets=(64,), device="cpu")
    assert eng_g.cfg.llm.moe_dispatch == "gather"


def test_engine_matches_jax(tiny):
    """Two videos at B 2 (128 prefill tokens: dense by the override in
    both Engines): greedy tokens identical to the JAX Engine's, plain and
    with speculation (k = 4, both Engines); then a session: the first turn
    with return_session and a continued text turn, identical to JAX's."""
    cfg, jp, tp = tiny
    frames = _videos(cfg)
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,),
                     attn_impl="xla", decode_chunk=4)
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 decode_chunk=4, device="cpu")
    for k in (0, 4):
        kw = dict(max_new_tokens=NEW_TOKENS, speculative_k=k)
        want = jeng.generate(PROMPTS, frames=frames,
                             gen=JaxGenerationConfig(**kw), eos_token_id=-1)
        got = eng.generate(PROMPTS, frames=frames,
                           gen=GenerationConfig(**kw), eos_token_id=-1)
        assert got == want
        assert all(len(o) == NEW_TOKENS for o in got)

    kw = dict(frames=frames[:1], eos_token_id=-1, return_session=True)
    got, sess = eng.generate(PROMPTS[:1],
                             gen=GenerationConfig(max_new_tokens=5), **kw)
    want, jsess = jeng.generate(PROMPTS[:1],
                                gen=JaxGenerationConfig(max_new_tokens=5),
                                **kw)
    assert got == want
    got, sess = eng.generate_continue(sess, [9, 10, 11],
                                      gen=GenerationConfig(max_new_tokens=6),
                                      eos_token_id=-1)
    want, jsess = jeng.generate_continue(
        jsess, [9, 10, 11], gen=JaxGenerationConfig(max_new_tokens=6),
        eos_token_id=-1)
    assert got == want and len(got[0]) == 6
    assert sess.token_history == jsess.token_history


# -- checkpoints ----------------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def test_from_jax_carries_the_experts(tiny):
    """The bridge fills every port parameter from the JAX tree (q/k/v
    fused) and leaves no JAX leaf unused; router and expert stacks come
    across as they are."""
    cfg, jp, tp = tiny
    layers = tp["llm"]["layers"]
    L, D, E, F_ = (cfg.llm.num_layers, cfg.llm.hidden_size,
                   cfg.llm.num_experts, cfg.llm.intermediate_size)
    assert tuple(layers["router"]["kernel"].shape) == (L, D, E)
    assert tuple(layers["gate"]["kernel"].shape) == (L, E, D, F_)
    assert tuple(layers["down"]["kernel"].shape) == (L, E, F_, D)
    for name in ("router", "gate", "up", "down"):
        np.testing.assert_array_equal(layers[name]["kernel"].numpy(),
                                      jp["llm"]["layers"][name]["kernel"])
    np.testing.assert_array_equal(
        layers["qkv"]["kernel"].numpy(),
        np.concatenate([jp["llm"]["layers"][n]["kernel"]
                        for n in ("q", "k", "v")], -1))
    shapes = dict(_flat(tvl2.param_shapes(cfg)))
    assert {p: tuple(t.shape) for p, t in _flat(tp)} == shapes
    extra = dict(jp, llm=dict(jp["llm"], layers=dict(
        jp["llm"]["layers"], spare={"kernel": np.zeros(2, np.float32)})))
    with pytest.raises(ValueError, match="not consumed"):
        params_from_jax(extra, cfg)


def _mixtral_state_dict(cfg, seed=0):
    """Seeded LLM tensors in the released Mixtral key layout (HF
    MixtralForCausalLM), as numpy."""
    rng = np.random.default_rng(seed)
    c = cfg.llm
    D, F_, E = c.hidden_size, c.intermediate_size, c.num_experts
    H, K, hd = c.num_heads, c.num_kv_heads, c.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)
    sd = {"model.embed_tokens.weight": w(c.vocab_size, D),
          "model.norm.weight": 1 + w(D), "lm_head.weight": w(c.vocab_size, D)}
    for l in range(c.num_layers):
        p = f"model.layers.{l}."
        sd.update({p + "input_layernorm.weight": 1 + w(D),
                   p + "post_attention_layernorm.weight": 1 + w(D),
                   p + "self_attn.q_proj.weight": w(H * hd, D),
                   p + "self_attn.k_proj.weight": w(K * hd, D),
                   p + "self_attn.v_proj.weight": w(K * hd, D),
                   p + "self_attn.o_proj.weight": w(D, H * hd),
                   p + "block_sparse_moe.gate.weight": w(E, D)})
        for e in range(E):
            q = f"{p}block_sparse_moe.experts.{e}."
            sd.update({q + "w1.weight": w(F_, D), q + "w2.weight": w(D, F_),
                       q + "w3.weight": w(F_, D)})
    return sd


def test_hf_mapper_matches_jax(tiny):
    """The port's mapper on an HF-layout Mixtral state dict gives JAX's
    tree leaf for leaf, and the config reader reads num_local_experts."""
    cfg = tiny[0]
    sd = _mixtral_state_dict(cfg)
    want = jconv.llm_params_from_state_dict(sd, cfg.llm)
    got = tconv.llm_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg.llm)
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(v),
                                      err_msg=str(path))
    hf = tconv.model_config_to_hf(cfg)
    assert (hf["num_local_experts"], hf["num_experts_per_tok"]) == (4, 2)
    assert dataclasses.asdict(tconv.model_config_from_hf(hf).llm) == \
        dataclasses.asdict(jconv.model_config_from_hf(hf).llm)


@pytest.fixture(scope="module")
def mixtral_ckpt(tmp_path_factory):
    """scripts/make_tiny_checkpoint.py's checkpoint made a VideoLLaMA2-8x7B
    one: its tower, connector, attention and norms, the MLP keys replaced
    by the released block_sparse_moe keys (4 experts), config.json with
    model_type videollama2_mixtral and num_local_experts."""
    from safetensors.numpy import load_file, save_file
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_tiny_checkpoint import build_checkpoint
    src = build_checkpoint(str(tmp_path_factory.mktemp("dense")))
    out = str(tmp_path_factory.mktemp("mixtral"))
    shutil.rmtree(out)
    shutil.copytree(src, out)
    with open(os.path.join(out, "config.json")) as f:
        cj = json.load(f)
    cj.update(model_type="videollama2_mixtral",
              architectures=["Videollama2MixtralForCausalLM"],
              num_local_experts=4, num_experts_per_tok=2)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(cj, f)
    sd = {k: v for k, v in load_file(os.path.join(out,
                                                  "model.safetensors")).items()
          if not (k.startswith("model.layers.") and ".mlp." in k)}
    cfg = jconv.model_config_from_hf(cj)
    assert cfg.llm.is_moe and cfg.llm.num_layers == 2
    sd.update({k: v for k, v in _mixtral_state_dict(cfg, seed=3).items()
               if "block_sparse_moe" in k})
    save_file(sd, os.path.join(out, "model.safetensors"))
    return out


def test_model_init_serves_a_mixtral_checkpoint(mixtral_ckpt):
    """model_init + mm_infer on the tiny VideoLLaMA2-8x7B directory (the
    mistral/mixtral <<SYS>> system prompt): the same tokens and string as
    JAX's; load_8bit / load_4bit raise NotImplementedError naming MoE
    before any weight is packed (JAX's packs load and fail in its MoE FFN
    with a KeyError, tests/test_torch_quant.py)."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(mixtral_ckpt, use_fast=True)
    jmodel, _, jtok = videollama2_tpu.model_init(
        mixtral_ckpt, dtype=jnp.float32, max_len=256, buckets=(128,),
        attn_impl="xla")
    tmodel, _, ttok = videollama2_tpu_torch.model_init(
        mixtral_ckpt, dtype=torch.float32, max_len=256, buckets=(128,),
        tokenizer=tok, device="cpu")
    assert tmodel.model_type == jmodel.model_type == "videollama2_mixtral"
    H = tmodel.config.vision.image_size
    video = np.random.default_rng(0).standard_normal(
        (tmodel.config.num_frames, H, H, 3), dtype=np.float32)
    streams = {}
    answers = {
        name: pkg.mm_infer(video, "What happens in the video ?", model, t,
                           modal="video", max_new_tokens=NEW_TOKENS,
                           stream_cb=lambda b, toks, name=name:
                           streams.__setitem__(name, list(toks)))
        for name, pkg, model, t in (
            ("jax", videollama2_tpu, jmodel, jtok),
            ("port", videollama2_tpu_torch, tmodel, ttok))}
    assert streams["port"] == streams["jax"] and len(streams["port"]) >= 1
    assert answers["port"] == answers["jax"]
    for flag in ("load_8bit", "load_4bit"):
        with pytest.raises(NotImplementedError, match="MoE"):
            videollama2_tpu_torch.model_init(
                mixtral_ckpt, tokenizer=tok, device="cpu", **{flag: True})


# -- training -------------------------------------------------------------------

SEQ = 64


def _instances(cfg, n=4, seed=1):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    out = []
    for i in range(n):
        text = [int(x) for x in rng.integers(3, cfg.llm.vocab_size,
                                             10 + 7 * i)]
        out.append({"input_ids": [1, VIDEO_TOKEN_INDEX] + text,
                    "labels": [IGNORE_INDEX, IGNORE_INDEX] + text,
                    "frames": rng.standard_normal((T, H, H, 3)).astype(
                        np.float32)})
    return out


def test_trainer_loss_and_grads_match_jax(tiny):
    """The Trainer's loss (train/step.loss_fn: forward_train, layers under
    remat) over 4 x 64 tokens, which the "auto" rule sends through the
    gather dispatch in both packages: loss within 1e-5, and the gradient
    of every LLM and connector tensor within 1e-4 of its largest value
    (q/k/v's taken from the fused qkv's)."""
    cfg, jp, tp = tiny
    assert cfg.llm.moe_dispatch == "auto"
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg))
    assert batch.text_ids.size >= 64
    jb = jdata.Batch(*(jnp.asarray(a) for a in batch))

    def jloss(train):
        return jvl2.forward_train({**jp, **train}, cfg, jb.frames,
                                  jb.text_ids, jb.is_visual, jb.vis_index,
                                  jb.positions, jb.valid_len, jb.labels)
    train = {"llm": jp["llm"], "connector": jp["connector"]}
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(train)
    jg = topt.flatten(_jax_view(jg))

    flat = {p: t for p, t in topt.flatten(tp).items()
            if p[0] in ("llm", "connector")}
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = tstep.loss_fn(tp, cfg, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    H, K, hd = cfg.llm.num_heads, cfg.llm.num_kv_heads, cfg.llm.head_dim
    cuts = {"q": (0, H * hd), "k": (H * hd, (H + K) * hd),
            "v": ((H + K) * hd, (H + 2 * K) * hd)}
    for path, want in jg.items():
        i = next((j for j, n in enumerate(path) if n in cuts), None)
        if i is None:
            got = flat[path].grad.numpy()
        else:
            a, b = cuts[path[i]]
            got = flat[path[:i] + ("qkv",) + path[i + 1:]].grad.numpy()[
                ..., a:b]
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg="/".join(path))
    for t in flat.values():
        t.requires_grad_(False)
        t.grad = None


def test_lora_refuses_expert_stacks(tiny_llm):
    """JAX's inject_lora unpacks each target kernel as (L, in, out), which
    a 4-axis expert stack cannot satisfy: a ValueError. The port refuses
    the same way, and, as JAX, adapts an MoE tree's attention when the
    targets leave the experts out."""
    cfg, jp, tp = tiny_llm
    with pytest.raises(ValueError):
        jlora.inject_lora(jax.random.PRNGKey(0), jp, jlora.LoraConfig(r=4))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="expert stack"):
        tlora.inject_lora(gen, tp, tlora.LoraConfig(r=4), cfg)
    attn_only = ("q", "k", "v", "o")
    jlora.inject_lora(jax.random.PRNGKey(0), jp,
                      jlora.LoraConfig(r=4, targets=attn_only))
    got = tlora.inject_lora(gen, tp, tlora.LoraConfig(r=4,
                                                      targets=attn_only),
                            cfg)["layers"]
    assert {n for n, e in got.items() if "lora" in e} == {"qkv", "o"}
