"""The port's checkpoint loader and public API against the JAX package.

A tiny VideoLLaMA2 checkpoint in the reference's HF format
(scripts/make_tiny_checkpoint.py: fp32 safetensors, CLIP + STCv35 +
Mistral, an offline word-level tokenizer with a Mistral chat template) is
loaded by both packages: the JAX-layout trees must be equal leaf for leaf,
bit for bit, and `model_init` + `mm_infer` / `mm_infer_batch` must give
the same greedy tokens and strings with fp32 frames (uint8 frames are cast
to bf16 before the tower in both packages; see tests/test_torch_engine.py).
The released VideoLLaMA2-7B-16F key layout
(tests/fixtures/manifests/videollama2_7b_16f.json) goes through the port's
mappers on meta tensors, which hold shapes but no data. Tied-embedding
first-token logits agree within 1e-4 in fp32.
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
from videollama2_tpu.core import config as jcfglib
from videollama2_tpu.inference import api as japi
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.multimodal import splice as jsplice
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
import videollama2_tpu_torch
from videollama2_tpu_torch.checkpoint import convert_hf as tconv
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.constants import VIDEO_TOKEN_INDEX
from videollama2_tpu_torch.core import config as tcfglib
from videollama2_tpu_torch.inference import api as tapi
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.multimodal import hf_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
MANIFEST = os.path.join(ROOT, "tests", "fixtures", "manifests",
                        "videollama2_7b_16f.json")
MANIFEST_AV = os.path.join(ROOT, "tests", "fixtures", "manifests",
                           "videollama2_1_7b_av.json")
FP32_LOGIT_ATOL = 1e-4
NEW_TOKENS = 8
TOWER_PREFIX = "model.vision_tower.vision_tower."


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from make_tiny_checkpoint import build_checkpoint
    return build_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def tokenizer(ckpt):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(ckpt, use_fast=True)


@pytest.fixture(scope="module")
def jax_loaded(ckpt):
    return videollama2_tpu.model_init(ckpt, dtype=jnp.float32, max_len=256,
                                      buckets=(128,), attn_impl="xla")


@pytest.fixture(scope="module")
def port_loaded(ckpt, tokenizer):
    return videollama2_tpu_torch.model_init(
        ckpt, dtype=torch.float32, max_len=256, buckets=(128,),
        tokenizer=tokenizer, device="cpu")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _assert_trees_equal(port_tree, jax_tree):
    got = dict(_flat(port_tree))
    want = dict(_flat(jax_tree))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert isinstance(g, torch.Tensor), path
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32, path
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


# -- the loader ---------------------------------------------------------------

def test_loader_matches_jax_leaf_for_leaf(ckpt):
    jcfg, jtree = jconv.load_videollama2(ckpt)
    tcfg, ttree = tconv.load_videollama2(ckpt)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(ttree, jtree)
    # the JAX layout goes whole into the port's, q/k/v fused
    port = params_from_jax(ttree, tcfg)
    assert "qkv" in port["llm"]["layers"] and "q" not in port["llm"]["layers"]


def _tower_dir(ckpt, out):
    """A standalone HF CLIPVisionModel directory: the checkpoint's tower
    keys without their model.vision_tower.vision_tower. prefix."""
    from safetensors.torch import load_file, save_file
    sd = load_file(os.path.join(ckpt, "model.safetensors"))
    os.makedirs(out)
    save_file({k[len(TOWER_PREFIX):]: v for k, v in sd.items()
               if k.startswith(TOWER_PREFIX)},
              os.path.join(out, "model.safetensors"))
    return sd


def test_pretrain_directory_matches_jax(ckpt, tmp_path):
    """Path (b): mm_projector.bin beside config.json, the LLM from
    model_base and the tower from vision_tower_path."""
    sd = _tower_dir(ckpt, str(tmp_path / "tower"))
    pre = tmp_path / "pretrain"
    pre.mkdir()
    shutil.copy(os.path.join(ckpt, "config.json"), pre / "config.json")
    torch.save({k: v for k, v in sd.items()
                if k.startswith("model.mm_projector.")},
               pre / "mm_projector.bin")
    kw = dict(model_base=ckpt, vision_tower_path=str(tmp_path / "tower"))
    jcfg, jtree = jconv.load_videollama2(str(pre), **kw)
    tcfg, ttree = tconv.load_videollama2(str(pre), **kw)
    _assert_trees_equal(ttree, jtree)
    # the same tree as the full checkpoint's
    _assert_trees_equal(ttree, jconv.load_videollama2(ckpt)[1])

    # without a tower directory: the port's seeded init, with the warning,
    # in the port's layout (q/k/v fused), which params_from_jax takes
    with pytest.warns(UserWarning, match="vision_tower_path"):
        _, seeded = tconv.load_videollama2(str(pre), model_base=ckpt)
    assert "qkv" in seeded["vision"]["layers"]
    params_from_jax(seeded, tcfg)


def test_unported_directories_raise(ckpt, tmp_path):
    # an AV config over weights without an audio tower: the branch is
    # seeded, with a warning, as a missing vision tower is
    av = tmp_path / "av"
    av.mkdir()
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg_json = json.load(f)
    with open(av / "config.json", "w") as f:
        json.dump(dict(cfg_json, mm_audio_tower="beats"), f)
    shutil.copy(os.path.join(ckpt, "model.safetensors"),
                av / "model.safetensors")
    with pytest.warns(UserWarning, match="no audio tower"):
        cfg, tree = tconv.load_videollama2(str(av))
    assert cfg.audio == tcfglib.AudioConfig()
    assert {p: tuple(t.shape) for p, t in _flat(tree["audio"])} == {
        p: tuple(s) for p, s in _flat(tvl2.param_shapes(cfg)["audio"])}


def _lora_dir(ckpt, out):
    """A LoRA directory over the tiny checkpoint, written by the JAX
    package's export_lora_split (adapters r 4 on every target, b nonzero)
    beside the checkpoint's tokenizer files. a and b are small multiples of
    powers of two, so every a @ b * s and its sum with a kernel is exact in
    fp32 whatever the order of the sums: the merged kernels, and the packs
    made from them, are the JAX package's bit for bit."""
    from videollama2_tpu.checkpoint import orbax_io as jorbax
    from videollama2_tpu.train import lora as jlora
    cfg, jtree = jconv.load_videollama2(ckpt)
    rng = np.random.default_rng(9)
    llm = jlora.inject_lora(jax.random.PRNGKey(1), jtree["llm"],
                            jlora.LoraConfig(r=4, alpha=8))
    layers = dict(llm["layers"])
    for name, entry in llm["layers"].items():
        if isinstance(entry, dict) and "lora" in entry:
            lo = dict(entry["lora"])
            lo["a"] = rng.integers(-4, 5, lo["a"].shape).astype(
                np.float32) / 16
            lo["b"] = rng.integers(-4, 5, lo["b"].shape).astype(
                np.float32) / 1024
            layers[name] = dict(entry, lora=lo)
    jorbax.export_lora_split(out, dict(llm, layers=layers),
                             jtree["connector"], cfg)
    for f in os.listdir(ckpt):
        if f not in ("config.json", "model.safetensors"):
            shutil.copy(os.path.join(ckpt, f), out)
    return out


@pytest.mark.parametrize("load_8bit", [False, True])
def test_model_init_loads_a_lora_directory(ckpt, tokenizer, tmp_path,
                                           load_8bit):
    """model_init(lora_dir, model_base=...) (path (a)): the adapters merged
    into the base kernels, load_8bit's packs made from the merged tree;
    the port's params equal the JAX model_init's fused by params_from_jax
    bit for bit, and mm_infer gives JAX's answer."""
    lora = _lora_dir(ckpt, str(tmp_path / "lora"))
    tower = str(tmp_path / "tower")
    _tower_dir(ckpt, tower)
    kw = dict(model_base=ckpt, vision_tower_path=tower, max_len=256,
              buckets=(128,), load_8bit=load_8bit,
              kv_bits=8 if load_8bit else 16)
    jmodel, _, jtok = videollama2_tpu.model_init(
        lora, dtype=jnp.float32, attn_impl="xla", **kw)
    tmodel, _, ttok = videollama2_tpu_torch.model_init(
        lora, dtype=torch.float32, tokenizer=tokenizer, device="cpu", **kw)
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.engine.params),
                           tmodel.config)
    got = dict(_flat(tmodel.engine.params))
    for path, w in _flat(want):
        g = got.pop(path)
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert not got
    if not load_8bit:
        _, base = tconv.load_videollama2(ckpt)
        for n in ("o", "gate", "up", "down"):
            assert not torch.equal(
                tmodel.engine.params["llm"]["layers"][n]["kernel"],
                base["llm"]["layers"][n]["kernel"]), n
    frames = _float_frames(tmodel.config, seed=2)
    # the port's packed dense takes W8A8, the JAX Engine's on a TPU only
    with jlayers.force_native_quant(load_8bit):
        want_answer = japi.mm_infer(frames, "What happens ?", jmodel, jtok,
                                    max_new_tokens=NEW_TOKENS)
    got_answer = tapi.mm_infer(frames, "What happens ?", tmodel, ttok,
                               max_new_tokens=NEW_TOKENS)
    assert got_answer == want_answer


def test_model_config_round_trip_matches_jax():
    for name in ("videollama2_mistral", "videollama2_qwen2"):
        t = tcfglib.preset(name).replace(num_frames=16)
        j = jcfglib.preset(name).replace(num_frames=16)
        assert tconv.model_config_to_hf(t) == jconv.model_config_to_hf(j)
        hf = tconv.model_config_to_hf(t)
        assert (dataclasses.asdict(tconv.model_config_from_hf(hf))
                == dataclasses.asdict(jconv.model_config_from_hf(hf)))


# -- the safetensors reader -----------------------------------------------------

def _mixed_tensors():
    g = torch.Generator().manual_seed(3)
    return {
        "bf16": torch.randn(5, 7, generator=g).bfloat16(),
        "f16": torch.randn(3, 4, 2, generator=g).half(),
        "f32": torch.randn(11, generator=g),
        "i8": torch.randint(-128, 127, (6, 5), generator=g,
                            dtype=torch.int8),
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (4,), generator=g,
                             dtype=torch.int32),
        "i64": torch.randint(-2 ** 40, 2 ** 40, (2, 3), generator=g),
        "bool": torch.rand(9, generator=g) > 0.5,
        "empty": torch.zeros(0, 4),
    }


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file
    path = str(tmp_path / "mixed.safetensors")
    save_file(_mixed_tensors(), path, metadata={"format": "pt"})
    want = load_file(path)
    got = tconv.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
    # views over a copy-on-write mapping: writing one leaves the file as is
    got["f32"].zero_()
    assert torch.equal(tconv.read_safetensors(path)["f32"], want["f32"])


def test_sharded_directory_ignores_the_index(tmp_path):
    from safetensors.torch import save_file
    t = _mixed_tensors()
    names = sorted(t)
    save_file({k: t[k] for k in names[:4]},
              str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({k: t[k] for k in names[4:]},
              str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    got = tconv.load_state_dict_from_dir(str(tmp_path))
    assert sorted(got) == names
    assert all(torch.equal(got[k], t[k]) for k in names)


def test_bin_directory(tmp_path):
    t = {k: v for k, v in _mixed_tensors().items() if k != "empty"}
    torch.save(t, tmp_path / "pytorch_model.bin")
    got = tconv.load_state_dict_from_dir(str(tmp_path))
    assert sorted(got) == sorted(t)
    assert all(torch.equal(got[k], t[k]) for k in t)


# -- the released 7B-16F layout ------------------------------------------------

class RecordingDict(dict):
    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _manifest_sd(path=MANIFEST):
    with open(path) as f:
        manifest = json.load(f)
    return manifest, RecordingDict(
        {k: torch.empty(s, dtype=torch.bfloat16, device="meta")
         for k, s in manifest.items()})


def test_videollama2_7b_16f_manifest_through_the_port():
    manifest, sd = _manifest_sd()
    cfg = tcfglib.preset("videollama2_mistral").replace(num_frames=16)
    tree = tconv.videollama2_params_from_state_dict(sd, cfg)
    unread = set(manifest) - sd.read
    assert not unread, f"manifest keys never consumed: {sorted(unread)[:10]}"
    assert sum(int(np.prod(s)) for s in manifest.values()) > 8e9
    # params_from_jax consumes every leaf and fills every port parameter
    port = params_from_jax(tree, cfg)
    got = {p: tuple(t.shape) for p, t in _flat(port)}
    want = dict(_flat(tvl2.param_shapes(cfg)))
    assert got == {p: tuple(s) for p, s in want.items()}
    assert all(t.dtype == torch.bfloat16 for _, t in _flat(port))


def test_manifest_misnamed_key_fails_in_the_port():
    _, sd = _manifest_sd()
    victim = "model.layers.0.self_attn.q_proj.weight"
    sd[victim + ".RENAMED"] = sd.pop(victim)
    cfg = tcfglib.preset("videollama2_mistral")
    with pytest.raises(KeyError):
        tconv.videollama2_params_from_state_dict(sd, cfg)


def test_av_manifest_raises_until_audio_is_ported():
    """The released VideoLLaMA2.1-AV layout goes through the port: every key
    is read but the relative_attention_bias tables of BEATs layers 1-11
    (BEATs, and both packages, use layer 0's for every layer) and SigLIP's
    attention-pooling head (the features are hidden states, as in the JAX
    package), and params_from_jax fills every port parameter, the audio
    branch in bf16."""
    manifest, sd = _manifest_sd(MANIFEST_AV)
    cfg = tcfglib.preset("videollama2_qwen2_av")
    tree = tconv.videollama2_params_from_state_dict(sd, cfg)
    unread = set(manifest) - sd.read
    pooling_head = {k for k in manifest
                    if ".vision_tower.vision_model.head." in k}
    assert pooling_head and unread - pooling_head == {
        f"model.audio_tower.encoder.layers.{l}.self_attn."
        "relative_attention_bias.weight" for l in range(1, 12)}
    audio_keys = [k for k in manifest
                  if k.startswith(("model.audio_tower.",
                                   "model.mm_projector_a."))]
    assert len(audio_keys) == 242
    port = params_from_jax(tree, cfg)
    got = {p: tuple(t.shape) for p, t in _flat(port)}
    want = dict(_flat(tvl2.param_shapes(cfg)))
    assert got == {p: tuple(s) for p, s in want.items()}
    assert all(t.dtype == torch.bfloat16 for _, t in _flat(port))


# -- tied embeddings -------------------------------------------------------------

def _tied_tiny(embed_kind):
    cfg = jcfglib.tiny_model(projector_type="stc_connector")
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm,
                                              tie_word_embeddings=True))
    jp = jvl2.init_params(jax.random.PRNGKey(2), cfg)
    assert "lm_head" not in jp["llm"]
    jp = jax.tree.map(np.asarray, jp)
    if embed_kind == "weight_q8":
        pack = jquant.quantize_int8(jnp.asarray(jp["llm"]["embed"]["weight"]),
                                    axis=-1)
        jp["llm"]["embed"] = {"weight_q8": jax.tree.map(np.asarray, pack)}
    return cfg, jp


@pytest.mark.parametrize("embed_kind", ["weight", "weight_q8"])
def test_tied_embedding_logits_match_jax(embed_kind):
    cfg, jp = _tied_tiny(embed_kind)
    tcfg = tcfglib.tiny_model(projector_type="stc_connector")
    tcfg = tcfg.replace(llm=dataclasses.replace(tcfg.llm,
                                                tie_word_embeddings=True))
    assert "lm_head" not in tvl2.param_shapes(
        tcfg, int8_embed=embed_kind == "weight_q8")["llm"]
    tp = params_from_jax(jp, tcfg)
    rng = np.random.default_rng(4)
    H = cfg.vision.image_size
    frames = rng.standard_normal((2, cfg.num_frames, H, H, 3),
                                 dtype=np.float32)
    prompts = [[1, 5, 9, VIDEO_TOKEN_INDEX, 17, 4],
               [1, 33, VIDEO_TOKEN_INDEX, 8, 2, 6, 200, 7]]
    plan = jsplice.plan_batch(prompts, cfg.tokens_per_video, 64)

    cache = jllm.init_cache(cfg.llm, 2, 128, jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(64), (2, 64))
    last, _ = jvl2.prefill_multimodal(
        jax.tree.map(jnp.asarray, jp), cfg, jnp.asarray(frames),
        jnp.asarray(plan.text_ids), jnp.asarray(plan.is_visual),
        jnp.asarray(plan.vis_index), pos, jnp.asarray(plan.valid_len), cache)
    want = np.asarray(jllm.lm_logits(jax.tree.map(jnp.asarray, jp["llm"]),
                                     cfg.llm, last))

    cache = tllm.init_cache(tcfg.llm, 2, 128, torch.float32)
    with torch.inference_mode():
        last, _ = tvl2.prefill_multimodal(
            tp, tcfg, torch.from_numpy(frames),
            torch.from_numpy(plan.text_ids).long(),
            torch.from_numpy(plan.is_visual),
            torch.from_numpy(plan.vis_index),
            torch.arange(64, dtype=torch.int32).expand(2, 64),
            torch.from_numpy(plan.valid_len), cache)
        got = tllm.lm_logits(tp["llm"], tcfg.llm, last).numpy()
    assert got.shape == (2, cfg.llm.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_LOGIT_ATOL)


# -- model_init / mm_infer / mm_infer_batch -----------------------------------

def _float_frames(cfg, seed=0):
    rng = np.random.default_rng(seed)
    H = cfg.vision.image_size
    return rng.standard_normal((cfg.num_frames, H, H, 3), dtype=np.float32)


@pytest.mark.parametrize("modal", ["video", "image", "text"])
def test_mm_infer_matches_jax(jax_loaded, port_loaded, modal):
    jmodel, _, jtok = jax_loaded
    tmodel, processor, ttok = port_loaded
    assert tmodel.model_type == jmodel.model_type == "videollama2_mistral"
    assert dataclasses.asdict(tmodel.config) == dataclasses.asdict(
        jmodel.config)
    media = None if modal == "text" else _float_frames(tmodel.config)
    streams = {}
    answers = {}
    for name, pkg, model, tok in (("jax", videollama2_tpu, jmodel, jtok),
                                  ("port", videollama2_tpu_torch, tmodel,
                                   ttok)):
        answers[name] = pkg.mm_infer(
            media, "What happens in the video ?", model, tok, modal=modal,
            max_new_tokens=NEW_TOKENS,
            stream_cb=lambda b, toks, name=name: streams.__setitem__(
                name, list(toks)))
    assert isinstance(answers["port"], str)
    assert streams["port"] == streams["jax"]
    assert len(streams["port"]) >= 1
    assert answers["port"] == answers["jax"]


def test_mm_infer_on_a_progressive_jpeg_matches_jax(jax_loaded, port_loaded):
    """A progressive JPEG image (tests/fixtures/torch_images/) through
    each package's image processor gives equal tensors and the same
    tokens from mm_infer."""
    path = os.path.join(ROOT, "tests", "fixtures", "torch_images",
                        "progressive_480x640.jpg")
    jmodel, jproc, jtok = jax_loaded
    tmodel, tproc, ttok = port_loaded
    jt, tt = np.asarray(jproc["image"](path)), np.asarray(tproc["image"](path))
    assert tt.dtype == jt.dtype
    np.testing.assert_array_equal(tt, jt)
    streams = {}
    for name, pkg, model, tok, tensor in (
            ("jax", videollama2_tpu, jmodel, jtok, jt),
            ("port", videollama2_tpu_torch, tmodel, ttok, tt)):
        pkg.mm_infer(tensor, "What is in the image ?", model, tok,
                     modal="image", max_new_tokens=NEW_TOKENS,
                     stream_cb=lambda b, toks, name=name: streams.__setitem__(
                         name, list(toks)))
    assert len(streams["port"]) >= 1
    assert streams["port"] == streams["jax"]


def test_mm_infer_batch_matches_jax(jax_loaded, port_loaded):
    jmodel, _, jtok = jax_loaded
    tmodel, _, ttok = port_loaded
    media = _float_frames(tmodel.config, seed=1)
    questions = ["What happens in the video ?", "Describe the scene briefly",
                 "why is the dog moving ?"]
    want = japi.mm_infer_batch(media, questions, jmodel, jtok,
                               max_new_tokens=NEW_TOKENS)
    got = tapi.mm_infer_batch(media, questions, tmodel, ttok,
                              max_new_tokens=NEW_TOKENS)
    assert got == want
    assert len(got) == 3 and all(isinstance(a, str) for a in got)


def test_api_surface_and_unported_parts(ckpt, port_loaded):
    model, processor, tok = port_loaded
    assert set(processor) == {"image", "video"}
    # the processors decode (tests/test_torch_media.py); a missing file and
    # a format the port does not read raise
    with pytest.raises(OSError, match="cannot open video"):
        processor["video"]("clip.mp4")
    with pytest.raises(NotImplementedError, match="arithmetic-coded JPEG"):
        processor["image"](b"\xff\xd8\xff\xc9\x00\x0b\x08\x00\x08\x00\x08"
                           b"\x01\x01\x11\x00\xff\xd9")
    # with no tokenizer object model_init reads the directory's
    # tokenizer.json; one that holds only tokenizer.model (which JAX's
    # use_fast=True converts) raises before any weight is read
    spm_only = os.path.join(os.path.dirname(ckpt), "spm_only")
    os.makedirs(spm_only, exist_ok=True)
    open(os.path.join(spm_only, "tokenizer.model"), "wb").close()
    with pytest.raises(hf_tokenizer.SentencePieceOnlyError,
                       match="tokenizer.model"):
        videollama2_tpu_torch.model_init(spm_only, device="cpu")
    with pytest.raises(ValueError, match="wire"):
        videollama2_tpu_torch.model_init(ckpt, tokenizer=tok, device="cpu",
                                         wire="yuv")
    # the audio modal needs the AV model (its API: test_torch_audio.py)
    with pytest.raises(ValueError, match="audio-visual model"):
        tapi.mm_infer(np.zeros((4, 8), np.float32), "hi", model, tok,
                      modal="audio")
    with pytest.raises(ValueError, match="Unsupported modal"):
        tapi.mm_infer_batch(None, ["hi"], model, tok, modal="text")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_load_gives_the_jax_packs(ckpt, tokenizer, bits):
    """load_8bit / load_4bit quantize on the device (here the CPU) the way
    the JAX model_init does: int8 LLM and tower, or folded int4 LLM, with
    an int8 head; the packs equal the JAX packs fused by params_from_jax
    bit for bit, and the model answers."""
    model, _, tok = videollama2_tpu_torch.model_init(
        ckpt, dtype=torch.float32, max_len=256, buckets=(128,),
        load_8bit=bits == 8, load_4bit=bits == 4, kv_bits=8,
        tokenizer=tokenizer, device="cpu")
    _, jtree = jconv.load_videollama2(ckpt)
    jtree["llm"] = jquant.quantize_llm_params(jtree["llm"], bits=bits)
    if bits == 8:
        jtree["vision"] = jquant.quantize_vision_params(jtree["vision"])
    want = params_from_jax(jax.tree.map(np.asarray, jtree), model.config)
    got = dict(_flat(model.engine.params))
    for path, w in _flat(want):
        g = got.pop(path)
        assert g.dtype == w.dtype, path
        assert torch.equal(g, w), path
    assert not got
    assert model.engine.kv_bits == 8
    answer = tapi.mm_infer(_float_frames(model.config), "What happens ?",
                           model, tok, max_new_tokens=4)
    assert isinstance(answer, str)


@pytest.fixture(scope="module")
def port_own_tokenizer(ckpt):
    """model_init with no tokenizer: the directory's own files."""
    return videollama2_tpu_torch.model_init(
        ckpt, dtype=torch.float32, max_len=256, buckets=(128,), device="cpu")


@pytest.mark.parametrize("modal", ["video", "image", "text"])
def test_model_init_reads_the_directory_tokenizer(jax_loaded, port_loaded,
                                                  port_own_tokenizer, modal):
    """model_init(path) with no tokenizer answers as JAX's model_init(path)
    (AutoTokenizer on the same directory) and as the port given
    AutoTokenizer: the same prompt ids, tokens and strings."""
    jmodel, _, jtok = jax_loaded
    tmodel, _, ttok = port_loaded
    omodel, _, otok = port_own_tokenizer
    assert isinstance(otok, hf_tokenizer.HFTokenizer)
    assert (otok.pad_token, otok.pad_token_id) == (jtok.pad_token,
                                                   jtok.pad_token_id)
    assert otok.eos_token_id == jtok.eos_token_id
    media = None if modal == "text" else _float_frames(omodel.config, seed=3)
    question = "What happens in the video ?"
    assert tapi.build_prompt_ids(question, omodel.config, otok, modal) == \
        japi.build_prompt_ids(question, jmodel.config, jtok, modal)
    answers, streams = {}, {}
    for name, pkg, model, tok in (
            ("jax", videollama2_tpu, jmodel, jtok),
            ("port", videollama2_tpu_torch, tmodel, ttok),
            ("own", videollama2_tpu_torch, omodel, otok)):
        answers[name] = pkg.mm_infer(
            media, question, model, tok, modal=modal,
            max_new_tokens=NEW_TOKENS,
            stream_cb=lambda b, toks, name=name: streams.__setitem__(
                name, list(toks)))
    assert streams["own"] == streams["jax"] == streams["port"]
    assert answers["own"] == answers["jax"] == answers["port"]
    assert answers["own"] == otok.decode(streams["own"],
                                         skip_special_tokens=True).strip()


def test_synthetic_path_reads_its_tokenizer_directory(ckpt, tokenizer):
    """synthetic://...&tokenizer=<dir> reads that directory's files (JAX
    _model_init_synthetic); without it and without an object, it raises
    as JAX's does."""
    path = f"synthetic://tiny?bits=8&kv_bits=8&max_len=256&tokenizer={ckpt}"
    own, _, otok = tapi.model_init(path, dtype=torch.float32,
                                   buckets=(128,), device="cpu")
    given, _, _ = tapi.model_init(path, dtype=torch.float32, buckets=(128,),
                                  tokenizer=tokenizer, device="cpu")
    assert isinstance(otok, hf_tokenizer.HFTokenizer)
    frames = _float_frames(own.config)
    assert tapi.mm_infer(frames, "What happens ?", own, otok,
                         max_new_tokens=4) == \
        tapi.mm_infer(frames, "What happens ?", given, tokenizer,
                      max_new_tokens=4)
    for api in (tapi, japi):
        with pytest.raises(ValueError, match="tokenizer="):
            api.model_init("synthetic://tiny?bits=8", device="cpu") \
                if api is tapi else api.model_init("synthetic://tiny?bits=8")


def test_e2e_smoke_script_runs_on_the_directory_tokenizer(ckpt, capsys):
    """scripts/e2e_smoke_torch.py --device cpu on the tiny checkpoint:
    model_init with no tokenizer, the processors, mm_infer (video, image,
    text, a batch, the I420 wire), each answer the decode of its tokens."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "e2e_smoke_torch", os.path.join(ROOT, "scripts", "e2e_smoke_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(["--model-path", ckpt, "--device", "cpu", "--dtype",
                 "float32", "--max-new-tokens", "6"])
    out = capsys.readouterr().out
    assert "tokenizer: HFTokenizer" in out
    for tag in ("VIDEO ANSWER:", "IMAGE ANSWER:", "TEXT ANSWER:",
                "BATCH ANSWERS:", "I420 ANSWER:"):
        assert tag in out
    assert out.rstrip().endswith("E2E OK")


def test_synthetic_model_path(tokenizer):
    model, processor, tok = tapi.model_init(
        "synthetic://tiny?bits=8&kv_bits=8&max_len=256", dtype=torch.float32,
        buckets=(128,), tokenizer=tokenizer, device="cpu")
    assert model.engine.kv_bits == 8 and model.engine.max_len == 256
    assert "kernel_q8" in model.engine.params["llm"]["layers"]["qkv"]
    answer = tapi.mm_infer(_float_frames(model.config), "What happens ?",
                           model, tok, max_new_tokens=4)
    assert isinstance(answer, str)


@pytest.mark.parametrize("model_type", ["videollama2_mistral",
                                        "videollama2_qwen2"])
@pytest.mark.parametrize("modal", ["video", "image", "text", "av"])
def test_build_prompt_ids_matches_jax(tokenizer, model_type, modal):
    jcfg = jcfglib.tiny_model(model_type)
    tcfg = tcfglib.tiny_model(model_type)
    for instruct in ("What happens in the video ?",
                     [{"role": "user", "content": "describe the scene"},
                      {"role": "assistant", "content": "a cat"},
                      {"role": "user", "content": "why ?"}]):
        want = japi.build_prompt_ids(instruct, jcfg, tokenizer, modal)
        got = tapi.build_prompt_ids(instruct, tcfg, tokenizer, modal)
        assert got == want
    assert tapi.MISTRAL_SYSTEM == japi.MISTRAL_SYSTEM
