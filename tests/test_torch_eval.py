"""The port's evaluation harness (videollama2_tpu_torch/eval) against the
JAX package's, on the CPU.

Every inference script's `main()` runs in both packages over the vendored
benchmark-format fixtures (tests/fixtures, as the JAX package's eval tests
run them), on the tiny checkpoint of scripts/make_tiny_checkpoint.py
loaded in fp32 (max_len 256, bucket 128): the JSONL records must be equal
field for field, and so must the scorers' reports and the GPT-judge
outputs (`--api none`). Also: `run_batched` tokens against JAX's,
`quant_accuracy.measure` on the tiny Mistral and Qwen2 LLMs (every
variant's KL within 1e-4 relative, top-1 / greedy / first divergence
exactly equal), `KeywordsStopper` through both Engines, and the Video-MME
subtitle alignment over the port's `probe_video`.
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import videollama2_tpu
import videollama2_tpu_torch
from videollama2_tpu.core import config as cfglib

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
KL_RTOL = 1e-4
# the least distance, relative to |q|, of every int8 rounding the port makes
# (W8A8 activations and KV rows, q = x / scale) from a .5 boundary: the
# packages' fp32 values differ by an ulp or two (~1e-7 relative), so a
# rounding closer than that may go the other way in JAX, and one such flip
# moves a KL of ~1e-7 by up to 5%, far past KL_RTOL (seen with the prompts
# of tests/test_quant_accuracy.py: a KV row at q = -93.499992, 8.2e-8
# from the boundary, and a W8A8 activation 6.8e-8 from it)
ROUNDING_MARGIN = 1.5e-7
QUANT_PROMPT_SEED = 18  # its prompts keep ROUNDING_MARGIN in both LLMs


def _port_llm(jp: dict) -> dict:
    """A JAX LLM tree (numpy leaves) as the port's: torch leaves, q/k/v
    fused into the qkv entry along the output axis."""
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    layers = tp["layers"]
    layers["qkv"] = {n: torch.cat([layers[p][n] for p in ("q", "k", "v")],
                                  dim=-1) for n in layers["q"]}
    for p in ("q", "k", "v"):
        del layers[p]
    return tp


# -- quant_accuracy -----------------------------------------------------------

class RoundingMargin:
    """The least relative distance of any int8 rounding of the port (its
    W8A8 activation rows and its KV cache rows) from a .5 boundary over a
    run (see ROUNDING_MARGIN)."""

    def __init__(self, monkeypatch):
        from videollama2_tpu_torch.models import llm as tllm
        from videollama2_tpu_torch.ops import layers as tlayers
        self.least = np.inf
        for module, name, per_row in ((tlayers, "_quantize_rows", False),
                                      (tllm, "_quantize_kv_rows", True)):
            monkeypatch.setattr(module, name,
                                self._recording(getattr(module, name),
                                                per_row))

    def _recording(self, quantize, per_row):
        def recording(x):
            xq, xs = quantize(x)
            q = torch.abs(x.float() / (xs[..., None] if per_row else xs))
            rel = ((q % 1.0) - 0.5).abs() / q.clamp(min=1.0)
            self.least = min(self.least, rel.min().item())
            return xq, xs
        return recording


@pytest.fixture(scope="module", params=["mistral", "qwen2"])
def quant_measured(request):
    """Both packages' measure() on the tiny LLM converted from a seeded HF
    model (as tests/test_quant_accuracy.py builds it), 3 prompts of 9-24
    tokens, 8 steps, bucket 48; with the port's least rounding margin."""
    from tests.test_llm_parity import _hf_model
    from videollama2_tpu.checkpoint.convert_hf import \
        llm_params_from_state_dict
    from videollama2_tpu.eval import quant_accuracy as jqa
    from videollama2_tpu_torch.core import config as tcfglib
    from videollama2_tpu_torch.eval import quant_accuracy as tqa

    torch.manual_seed(0)
    cfg = cfglib.tiny_llm(request.param)
    hf = _hf_model(request.param, cfg).eval()
    jp = llm_params_from_state_dict(hf.state_dict(), cfg)
    rng = np.random.default_rng(QUANT_PROMPT_SEED)
    prompts = [np.concatenate([[1], rng.integers(4, cfg.vocab_size - 1,
                                                 rng.integers(8, 24))])
               for _ in range(3)]
    kw = dict(steps=8, bucket=48, max_len=128)
    want = jqa.measure(jp, cfg, prompts, dtype=jnp.float32, **kw)
    with pytest.MonkeyPatch.context() as mp:
        margin = RoundingMargin(mp)
        got = tqa.measure(_port_llm(jp), tcfglib.tiny_llm(request.param),
                          prompts, dtype=torch.float32, device="cpu", **kw)
    return got, want, margin.least


@pytest.mark.parametrize("variant", ["int8", "int4", "int8+w8a8", "kv8",
                                     "int8+kv8", "int4+kv8"])
def test_quant_accuracy_matches_jax(quant_measured, variant):
    """Six variants (int8 / int4 packs, W8A8 prefill, int8 KV cache and
    their combinations) against the fp32 reference: KL within KL_RTOL of
    JAX's, the rest exactly equal; every rounding the port makes keeps
    ROUNDING_MARGIN from a boundary, where fp32 noise cannot flip it."""
    got, want, least = quant_measured
    assert least >= ROUNDING_MARGIN, least
    assert list(got) == list(want)
    g, w = got[variant], want[variant]
    np.testing.assert_allclose(g["kl"], w["kl"], rtol=KL_RTOL, atol=0)
    for key in ("top1_agreement", "greedy_exact_match",
                "mean_first_divergence", "steps", "prompts"):
        assert g[key] == w[key], (variant, key, g, w)


# -- the seven inference scripts, the scorers and the judge ------------------

def hf_tokenizer(path):
    """The inference scripts' --tokenizer factory in these tests
    (transformers is on this host): the tokenizer the JAX package's
    model_init loads."""
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(path, use_fast=True)


TOKENIZER = "test_torch_eval:hf_tokenizer"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from make_tiny_checkpoint import build_checkpoint
    return build_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def jax_loaded(ckpt):
    return videollama2_tpu.model_init(ckpt, dtype=jnp.float32, max_len=256,
                                      buckets=(128,), attn_impl="xla")


@pytest.fixture(scope="module")
def port_loaded(ckpt):
    return videollama2_tpu_torch.model_init(
        ckpt, dtype=torch.float32, max_len=256, buckets=(128,),
        tokenizer=hf_tokenizer(ckpt), device="cpu")


def _write_gif(path, seed=0, n=6):
    rng = np.random.default_rng(seed)
    frames = [Image.fromarray(rng.integers(0, 255, (32, 32, 3),
                                           dtype=np.uint8))
              for _ in range(n)]
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    frames[0].save(str(path), save_all=True, append_images=frames[1:],
                   duration=50)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """The JAX package's eval tests' media (GIFs named as the fixtures'
    videos, flat and in MVBench's per-task roots) plus an MVBench "frame"
    task, Episodic Reasoning: a directory of baseline JPEG frames (the
    GPU host's media: no libavcodec there) and its annotation file beside
    the fixture's two."""
    from jpeg_writer import encode_jpeg
    root = tmp_path_factory.mktemp("media")
    for i, name in enumerate(("fixtvid01", "fixtvid02", "fixtvid03")):
        _write_gif(root / f"{name}.gif", seed=i)
    _write_gif(root / "mvb" / "star" / "Charades_v1_480" / "fixtvid01.gif",
               seed=10)
    _write_gif(root / "mvb" / "clevrer" / "video_validation" /
               "fixtvid02.gif", seed=11)
    frames = root / "mvb" / "tvqa" / "frames_fps3_hq" / "clip01"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(12)
    for i in range(12):
        img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        (frames / f"{i:05d}.jpg").write_bytes(encode_jpeg(img, quality=90))
    questions = root / "mvbench_json"
    questions.mkdir()
    for name in os.listdir(os.path.join(FIXTURES, "mvbench", "json")):
        (questions / name).write_bytes(
            open(os.path.join(FIXTURES, "mvbench", "json", name),
                 "rb").read())
    (questions / "episodic_reasoning.json").write_text(json.dumps([{
        "video": "clip01", "question": "What does the man hold?",
        "candidates": ["A cup.", "A phone.", "A book."],
        "answer": "A phone.", "start": 0.5, "end": 3.5}]))
    return str(root)


def _failing_loudly(fn):
    """fn, failing the test where it raises: an inference script turns a
    failure into a default answer ("C", "error", empty responses), so
    equal records alone would not show that either package answered."""
    def call(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - reported, then failed
            pytest.fail(f"{fn.__module__}.{fn.__name__} raised {e!r}")
    return call


@pytest.fixture
def both_inits(ckpt, jax_loaded, monkeypatch):
    """Each package's model_init as the inference scripts reach it: JAX's
    returns its loaded fp32 model; the port's loads the checkpoint through
    the real model_init in fp32 (max_len 256, bucket 128), with the
    tokenizer the script's --tokenizer factory made and its --device."""
    real = videollama2_tpu_torch.model_init
    seen = []

    def port_init(model_path, tokenizer=None, device="cuda", **kw):
        assert model_path == ckpt and not kw
        seen.append((type(tokenizer).__name__, device))
        return real(model_path, tokenizer=tokenizer, device=device,
                    dtype=torch.float32, max_len=256, buckets=(128,))

    def jax_init(model_path, **kw):
        assert model_path == ckpt and not kw
        return jax_loaded

    monkeypatch.setattr(videollama2_tpu_torch, "model_init", port_init)
    monkeypatch.setattr(videollama2_tpu, "model_init", jax_init)
    for package in (videollama2_tpu, videollama2_tpu_torch):
        api = importlib.import_module(f"{package.__name__}.inference.api")
        for owner, name in ((package, "mm_infer"), (api, "mm_infer_batch")):
            monkeypatch.setattr(owner, name,
                                _failing_loudly(getattr(owner, name)))
    # what each port inference script's model_init must get: the JAX
    # model_init's tokenizer class, made by the --tokenizer factory, and
    # --device cpu
    seen.append((type(jax_loaded[2]).__name__, "cpu"))
    return seen


def _run(package, module, argv, monkeypatch):
    mod = importlib.import_module(f"{package}.eval.{module}")
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    mod.main()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_both(module, argv_of, tmp_path, monkeypatch, seen):
    """Runs the inference script in both packages (the port's with
    --tokenizer and --device cpu); argv_of(out_dir) -> the shared flags.
    Returns the two output directories."""
    outs = {}
    for package in ("videollama2_tpu", "videollama2_tpu_torch"):
        out = tmp_path / package
        out.mkdir()
        extra = (["--tokenizer", TOKENIZER, "--device", "cpu"]
                 if package.endswith("_torch") else [])
        _run(package, module, argv_of(out) + extra, monkeypatch)
        outs[package] = out
    assert len(seen) >= 2 and seen[-1] == seen[0], seen
    return outs["videollama2_tpu"], outs["videollama2_tpu_torch"]


def _assert_same_jsonl(jdir, tdir, name):
    want, got = _read_jsonl(jdir / name), _read_jsonl(tdir / name)
    assert want, name
    assert got == want


def _judge_both(dimension, jdir, tdir, pred, monkeypatch):
    """gpt_judge --api none over each package's predictions: the reports
    and the per-sample result files equal."""
    for package, d in (("videollama2_tpu", jdir),
                       ("videollama2_tpu_torch", tdir)):
        _run(package, "gpt_judge",
             ["--dimension", dimension, "--pred-file", str(d / pred),
              "--output-dir", str(d / "judge"), "--api", "none",
              "--output-json", str(d / "judge.json")], monkeypatch)
    with open(jdir / "judge.json") as f, open(tdir / "judge.json") as g:
        assert json.load(g) == json.load(f)
    names = sorted(os.listdir(jdir / "judge"))
    assert names and sorted(os.listdir(tdir / "judge")) == names
    for n in names:
        assert (tdir / "judge" / n).read_bytes() == \
            (jdir / "judge" / n).read_bytes()


@pytest.mark.parametrize("question_format", ["parquet", "json"])
def test_videomme_inference_and_scorer_match_jax(
        question_format, ckpt, both_inits, media, tmp_path, monkeypatch,
        capsys):
    """Video-MME from the published parquet or the pre-grouped JSON (the
    GPU host has no pandas): both answer files, the merge and the scorer's
    report equal JAX's; subtitles aligned over each package's probe_video."""
    from videollama2_tpu.eval.inference_video_mcqa_videomme import \
        load_parquet
    qfile = os.path.join(FIXTURES, "videomme", "questions.parquet")
    if question_format == "json":
        grouped = tmp_path / "questions.json"
        grouped.write_text(json.dumps(load_parquet(qfile)))
        qfile = str(grouped)
    jdir, tdir = _run_both(
        "inference_video_mcqa_videomme", lambda out: [
            "--model-path", ckpt,
            "--video-folder", media,
            "--subtitle-folder", os.path.join(FIXTURES, "videomme",
                                              "subtitles"),
            "--question-file", qfile, "--answer-file",
            str(out / "1_0.json")], tmp_path, monkeypatch, both_inits)
    for name in ("1_0.json", "1_0_sub.json"):
        _assert_same_jsonl(jdir, tdir, name)
    recs = _read_jsonl(tdir / "1_0.json")
    assert all(r["missing"] is False for r in recs) and len(recs) == 3
    reports = []
    for package, d in (("videollama2_tpu", jdir),
                       ("videollama2_tpu_torch", tdir)):
        common = importlib.import_module(f"{package}.eval.common")
        scorer = importlib.import_module(
            f"{package}.eval.eval_video_mcqa_videomme")
        common.merge_chunks([str(d / "1_0.json")], str(d / "merge.json"))
        reports.append(scorer.eval_your_results(
            str(d / "merge.json"), video_types="short,medium,long",
            skip_missing=True, return_categories_accuracy=True,
            return_sub_categories_accuracy=True,
            return_task_types_accuracy=True))
    assert reports[1] == reports[0]
    assert reports[1]["overall"]["answered"] == 9
    capsys.readouterr()


def test_mvbench_inference_and_scorer_match_jax(ckpt, both_inits, media,
                                             tmp_path, monkeypatch, capsys):
    """MVBench over two "video" tasks (GIFs, one with start/end bounds) and
    the "frame" task (a JPEG directory): records and score table equal."""
    jdir, tdir = _run_both(
        "inference_video_mcqa_mvbench", lambda out: [
            "--model-path", ckpt,
            "--question-file", os.path.join(media, "mvbench_json"),
            "--video-folder", os.path.join(media, "mvb"),
            "--answer-file", str(out / "mvbench.jsonl")],
        tmp_path, monkeypatch, both_inits)
    _assert_same_jsonl(jdir, tdir, "mvbench.jsonl")
    recs = _read_jsonl(tdir / "mvbench.jsonl")
    assert {r["task_type"] for r in recs} == {
        "Action Sequence", "Object Existence", "Episodic Reasoning"}
    from videollama2_tpu.eval.eval_video_mcqa_mvbench import score as jscore
    from videollama2_tpu_torch.eval.eval_video_mcqa_mvbench import \
        score as tscore
    assert tscore(recs) == jscore(_read_jsonl(jdir / "mvbench.jsonl"))
    capsys.readouterr()


@pytest.mark.parametrize("module,fixture,mode", [
    ("inference_video_mcqa_egoschema", "egoschema/questions.json", None),
    ("inference_video_mcqa_perception_test_mcqa",
     "perception/mc_question_test.json", None),
    ("inference_video_oqa_vcgpt", "vcgpt/general.json", "general"),
    ("inference_video_oqa_vcgpt", "vcgpt/consistency.json", "consistency"),
])
def test_mcqa_and_vcgpt_inference_match_jax(module, fixture, mode, ckpt,
                                          both_inits, media, tmp_path,
                                          monkeypatch, capsys):
    """EgoSchema (a missing video degrades to "C"), Perception Test and
    Video-ChatGPT's two modes (with the consistency judge): equal
    records."""
    jdir, tdir = _run_both(
        module, lambda out: (["--mode", mode] if mode else []) + [
            "--model-path", ckpt, "--video-folder", media,
            "--question-file", os.path.join(FIXTURES, fixture),
            "--answer-file", str(out / "out.jsonl")],
        tmp_path, monkeypatch, both_inits)
    _assert_same_jsonl(jdir, tdir, "out.jsonl")
    if mode == "consistency":
        _judge_both("consistency", jdir, tdir, "out.jsonl", monkeypatch)
    capsys.readouterr()


@pytest.mark.parametrize("module,argv,dimension", [
    ("inference_video_oqa_activitynet",
     ["--question-file", "activitynet/test_q.json",
      "--answer-file", "activitynet/test_a.json"], "activitynet"),
    ("inference_video_cap_msvc", ["--question-file", "msvc/msvc.json"],
     "msvc_correctness"),
])
def test_oqa_and_caption_inference_and_judge_match_jax(
        module, argv, dimension, ckpt, both_inits, media, tmp_path,
        monkeypatch, capsys):
    """ActivityNet-QA (a missing video gives pred "error") and MSVC, then
    gpt_judge --api none over each package's predictions."""
    flags = [os.path.join(FIXTURES, a) if a.endswith(".json") else a
             for a in argv]
    jdir, tdir = _run_both(
        module, lambda out: ["--model-path", ckpt, "--video-folder", media]
        + flags + ["--output-file", str(out / "out.jsonl")],
        tmp_path, monkeypatch, both_inits)
    _assert_same_jsonl(jdir, tdir, "out.jsonl")
    _judge_both(dimension, jdir, tdir, "out.jsonl", monkeypatch)
    capsys.readouterr()


# -- run_batched, KeywordsStopper, subtitle alignment -------------------------

def _recording_generate(engine, store, monkeypatch):
    """Record the token rows engine.generate returns."""
    generate = engine.generate

    def recording(*args, **kwargs):
        outs = generate(*args, **kwargs)
        store.extend([int(t) for t in o] for o in outs)
        return outs
    monkeypatch.setattr(engine, "generate", recording)


def test_run_batched_matches_jax(jax_loaded, port_loaded, monkeypatch):
    """4 videos x 3 questions at batch_prompts 4 (batches flush at video
    boundaries: 6 prompts over 2 media, twice), fp32 frames: the same
    media groups, tokens and texts in the same order as JAX's."""
    from videollama2_tpu.eval.batch_runner import run_batched as jrun
    from videollama2_tpu_torch.eval.batch_runner import run_batched as trun
    runs = {}
    for name, run, (model, _, tok) in (("jax", jrun, jax_loaded),
                                       ("port", trun, port_loaded)):
        T, H = model.config.num_frames, model.config.vision.image_size
        items = [{"vid": f"v{i}", "seed": i,
                  "questions": [f"what is in clip {i} ?", f"why {i} ?",
                                f"who moves first in {i} ?"]}
                 for i in range(4)]
        tokens, results, groups = [], [], []
        _recording_generate(model.engine, tokens, monkeypatch)
        generate = model.engine.generate

        def grouped(*args, media_group=None, _generate=generate, **kwargs):
            groups.append(list(media_group))
            return _generate(*args, media_group=media_group, **kwargs)
        monkeypatch.setattr(model.engine, "generate", grouped)

        def load_media(item, T=T, H=H):
            rng = np.random.default_rng(item["seed"])
            return rng.standard_normal((T, H, H, 3)).astype(np.float32)

        run(model, tok, items, load_media,
            lambda item: [({"q": q}, q) for q in item["questions"]],
            lambda item, meta, text: results.append(
                (item["vid"], meta["q"], text)),
            batch_prompts=4, max_new_tokens=8)
        runs[name] = (tokens, results, groups)
    assert runs["port"] == runs["jax"]
    tokens, results, groups = runs["port"]
    assert groups == [[0, 0, 0, 1, 1, 1]] * 2
    assert len(results) == 12 and all(len(t) == 8 for t in tokens)


def test_keywords_stopper_matches_jax(jax_loaded, port_loaded):
    """KeywordsStopper (a two-token keyword from an unstopped reply) as the
    stop_fn of both Engines: both stop on the same token, where the
    keyword's text first appears."""
    from videollama2_tpu.inference import api as japi
    from videollama2_tpu.inference.engine import \
        GenerationConfig as JaxGenerationConfig
    from videollama2_tpu.utils.misc import KeywordsStopper as JaxStopper
    from videollama2_tpu_torch.inference import api as tapi
    from videollama2_tpu_torch.inference.engine import GenerationConfig
    from videollama2_tpu_torch.utils.misc import KeywordsStopper
    model, _, tok = port_loaded
    ids = tapi.build_prompt_ids("describe the weather today", model.config,
                                tok, "text")
    assert ids == japi.build_prompt_ids("describe the weather today",
                                        jax_loaded[0].config, jax_loaded[2],
                                        "text")
    free = model.engine.generate([ids], gen=GenerationConfig(
        max_new_tokens=24))[0]
    assert len(free) >= 8
    keyword = tok.decode(free[5:7], skip_special_tokens=True).strip()
    assert keyword
    got = model.engine.generate(
        [ids], gen=GenerationConfig(max_new_tokens=24),
        eos_token_id=tok.eos_token_id,
        stop_fn=KeywordsStopper([keyword], tok).as_stop_fn())[0]
    want = jax_loaded[0].engine.generate(
        [ids], gen=JaxGenerationConfig(max_new_tokens=24),
        eos_token_id=jax_loaded[2].eos_token_id,
        stop_fn=JaxStopper([keyword], jax_loaded[2]).as_stop_fn())[0]
    assert [int(t) for t in want] == got
    assert got == free[:len(got)] and 2 <= len(got) <= 7
    assert keyword in tok.decode(got, skip_special_tokens=True)


def test_videomme_subtitles_over_the_ports_probe(media):
    """probe_video of a GIF and of a frame directory, the sampled indices
    and the aligned subtitles equal the JAX package's."""
    from videollama2_tpu.eval import inference_video_mcqa_videomme as jvm
    from videollama2_tpu.media import sampler as jsampler
    from videollama2_tpu.media.video_reader import probe_video as jprobe
    from videollama2_tpu_torch.eval import inference_video_mcqa_videomme \
        as tvm
    from videollama2_tpu_torch.media import sampler as tsampler
    from videollama2_tpu_torch.media.video_reader import \
        probe_video as tprobe
    srt = os.path.join(FIXTURES, "videomme", "subtitles", "fixtvid01.srt")
    for video in (os.path.join(media, "fixtvid01.gif"),
                  os.path.join(media, "mvb", "tvqa", "frames_fps3_hq",
                               "clip01")):
        (total, fps) = tprobe(video)
        assert (total, fps) == jprobe(video)
        idx = tsampler.sample_indices(total, fps, 16)
        assert list(idx) == list(jsampler.sample_indices(total, fps, 16))
        text = tvm.align_subtitles(srt, idx, fps)
        assert text == jvm.align_subtitles(srt, idx, fps) and text
    assert tvm.parse_srt(srt) == jvm.parse_srt(srt)


def test_quant_accuracy_cli_reads_a_checkpoint(ckpt, port_loaded, capsys):
    """scripts/quant_accuracy_torch.py on the tiny checkpoint (bf16, on the
    CPU): six variants, the numbers of measure() on model_init's LLM."""
    import quant_accuracy_torch as cli
    from videollama2_tpu_torch.eval import quant_accuracy as tqa
    got = cli.main(["--model-path", ckpt, "--device", "cpu", "--steps", "4",
                    "--prompts", "2", "--bucket", "48", "--json"])
    assert json.loads(capsys.readouterr().out) == got
    assert list(got) == [v.name for v in tqa.DEFAULT_VARIANTS]
    model = port_loaded[0]
    want = tqa.measure(model.engine.params["llm"], model.config.llm,
                       cli.seeded_prompts(model.config.llm.vocab_size, 2,
                                          48),
                       steps=4, bucket=48, max_len=256,
                       dtype=torch.bfloat16, device="cpu")
    assert got == want
    for m in got.values():
        assert m["kl"] >= 0 and 0 <= m["top1_agreement"] <= 1
