"""The port's training entry point (videollama2_tpu_torch/train/train.py)
and what it reads, against the JAX package's, on the CPU at tiny sizes
(tiny_model(), the tiny Qwen2 regrouped to 7 query heads a kv head): the
preprocess functions, the dataset over a PNG + JPEG + GIF + frame
directory + text corpus (items and frames bit-equal), the length-grouped
sampler, the Trainer's step losses over the dataset, resume and
preemption, the train state on disk, export_hf_projector_bin, and main()
with the recipes' flags against JAX's main(). JAX runs on a one-device
mesh, as its own tests run it.

Tolerances (fp32 on both sides): step losses within LOSS_RTOL relative
(different attention and reduction orders; measured ~1e-7 here), the
saved projector after one step within 1e-5 of its largest weight plus
PARAM_LR_FRAC of the learning rate: Adam's first update is
lr * g / (|g| + eps), so a gradient within a few eps of zero, whose float32
rounding differs between the packages, moves its weight by a different
fraction of lr (measured: 1 element in ~4000 off by up to 0.4% of lr).
Under --bf16 (the port computes in bf16, JAX in fp32 but for the frames):
the loss within BF16_LOSS_RTOL (measured 1.1e-5), and in every tensor of
adapter-1/ at least BF16_UPDATES_NEAR of the elements within the fp32
bound above (measured 0.954 at the worst; bf16-rounded masters score 0 on
the norm scales, whose ulp at 1.0 is 8 times the update)."""

import dataclasses
import io
import json
import os
import random
import signal
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from videollama2_tpu.checkpoint import orbax_io as jorbax
from videollama2_tpu.core import config as jcfglib
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.models import vit as jvit
from videollama2_tpu.parallel import mesh as jmesh
from videollama2_tpu.train import data as jdata
from videollama2_tpu.train import optimizer as jopt
from videollama2_tpu.train import train as jtrain
from videollama2_tpu.train import trainer as jtrainer
from videollama2_tpu_torch.checkpoint import convert_hf as tconv
from videollama2_tpu_torch.checkpoint import projector_io, train_state
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.core import config as tcfglib
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep
from videollama2_tpu_torch.train import train as ttrain
from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
from gif_writer import encode_rgb_gif  # noqa: E402
from jpeg_writer import PROGRESSIVE, encode_jpeg  # noqa: E402
from png_writer import encode_png  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_LR_FRAC = 1e-2
BF16_LOSS_RTOL = 1e-3
BF16_UPDATES_NEAR = 0.9
SEQ = 160
SEED = 7
TOKENIZER = "test_torch_train_entry:hf_tokenizer"


def hf_tokenizer(path):
    """The --tokenizer factory of these tests (transformers is on this
    host, not in the port)."""
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(path)


def _smooth(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 5 + y * 3 + 60 * c for c in range(3)], -1)
    return ((base + rng.integers(0, 16, (h, w, 3))) % 256).astype(np.uint8)


def _turns(tag, i, rounds):
    out = []
    for r in range(rounds):
        q = "what happens in the video ?" if r == 0 else f"why tok{i} ?"
        out += [{"from": "human",
                 "value": (f"{tag}\n" if tag and r == 0 else "") + q},
                {"from": "gpt", "value": " ".join(
                    ["the cat jumps"] * (1 + (i + r) % 3)) + " ."}]
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Media in the reference's annotation format: GIF videos, frame
    directories of JPEG and PNG files, JPEG (PIL's and jpeg_writer's) and
    PNG images; pre.json (one round, media only: the pretrain stage) and
    sft.json (one to three rounds, plus two text-only samples)."""
    root = tmp_path_factory.mktemp("corpus")
    media = root / "media"
    media.mkdir()
    rng = np.random.default_rng(0)
    entries = []
    for i in range(3):
        (media / f"g{i}.gif").write_bytes(encode_rgb_gif(
            np.stack([_smooth(rng, 24, 32) for _ in range(6)])))
        entries.append(("video", f"media/g{i}.gif"))
    for i, fmt in enumerate(("jpg", "jpg", "png", "png")):
        d = media / f"frames{i}"
        d.mkdir()
        for f in range(5):
            px = _smooth(rng, 30, 40)
            data = (encode_jpeg(px, 80, "4:2:0") if fmt == "jpg"
                    else encode_png(px))
            (d / f"{f:03d}.{fmt}").write_bytes(data)
        entries.append(("video", f"media/frames{i}"))
    for i, (fmt, kw) in enumerate((("JPEG", dict(quality=75)),
                                   ("JPEG", dict(quality=90, subsampling=0)),
                                   ("PNG", {}))):
        name = f"media/i{i}.{fmt.lower()}"
        Image.fromarray(_smooth(rng, 44, 36)).save(str(root / name), fmt, **kw)
        entries.append(("image", name))
    pre, sft = [], []
    for i, (kind, path) in enumerate(entries):
        tag = f"<{kind}>"
        pre.append({kind: path, "conversations": _turns(tag, i, 1)})
        sft.append({kind: path, "conversations": _turns(tag, i, 1 + i % 3)})
    for i in range(2):
        sft.append({"conversations": _turns(None, 20 + i, 1 + i)})
    for name, annos in (("pre.json", pre), ("sft.json", sft)):
        with open(root / name, "w") as f:
            json.dump(annos, f)
    return str(root)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from make_tiny_checkpoint import build_checkpoint
    return build_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def tok(ckpt):
    return hf_tokenizer(ckpt)


def _cfgs():
    return jcfglib.tiny_model(), tcfglib.tiny_model()


def _datasets(corpus, tok, anno, is_pretraining=False, seed=0):
    jcfg, tcfg = _cfgs()
    path = [os.path.join(corpus, anno)]
    jda = jdata.DataArguments(data_path=path, data_folder=corpus,
                              is_pretraining=is_pretraining)
    tda = tdata.DataArguments(data_path=path, data_folder=corpus,
                              is_pretraining=is_pretraining)
    return (jdata.SupervisedDataset(path, tok, jda, jcfg),
            tdata.SupervisedDataset(path, tok, tda, tcfg, seed=seed))


@pytest.fixture()
def one_device(monkeypatch):
    """JAX's Trainer on a one-device mesh (its tests' 8 virtual devices
    would make a batch 8 times the port's)."""
    orig = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda **kw: orig(
        devices=jax.devices()[:1], **kw))


# -- preprocessing, the dataset and the sampler -------------------------------

def test_preprocess_matches_jax(corpus, tok):
    with open(os.path.join(corpus, "sft.json")) as f:
        sft = json.load(f)
    for sample in sft:
        tag = next((f"<{k}>" for k in ("video", "image") if k in sample),
                   None)
        jsrc = [json.loads(json.dumps(sample["conversations"]))]
        tsrc = [json.loads(json.dumps(sample["conversations"]))]
        if tag:
            jsrc = jdata.preprocess_multimodal(jsrc, tag)
            tsrc = tdata.preprocess_multimodal(tsrc, tag)
            assert tsrc == jsrc
        fns = [(jdata.preprocess, tdata.preprocess)]
        if tag and len(jsrc[0]) == 2:
            fns.append((jdata.preprocess_plain, tdata.preprocess_plain))
        for jfn, tfn in fns:
            want, got = jfn(jsrc, tok, tag), tfn(tsrc, tok, tag)
            for key in ("input_ids", "labels"):
                np.testing.assert_array_equal(got[key][0], want[key][0])
            assert (got["labels"][0] == -100).any()
            assert (got["labels"][0] != -100).any()


@pytest.mark.parametrize("anno,pre", [("pre.json", True), ("sft.json", False)])
def test_dataset_items_match_jax(corpus, tok, anno, pre):
    jds, tds = _datasets(corpus, tok, anno, is_pretraining=pre)
    assert len(tds) == len(jds)
    assert tds.modality_lengths == jds.modality_lengths
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        for key in ("input_ids", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["frames"].dtype == want["frames"].dtype
        np.testing.assert_array_equal(got["frames"], want["frames"])


def test_dataset_reads_every_image_format_as_jax(corpus, tok, tmp_path):
    """Images and frame directories in the formats the port's reader
    gained (progressive, CMYK and RGB-coded JPEG, Adam7, 16-bit and 2-bit
    PNG, a GIF still) give the JAX dataset's items."""
    rng = np.random.default_rng(8)
    writers = {
        "prog.jpg": lambda px: encode_jpeg(px, 80, "4:2:0",
                                           script=PROGRESSIVE),
        "cmyk.jpg": lambda px: _pil_file(Image.fromarray(px).convert(
            "CMYK"), "JPEG"),
        "rgb.jpg": lambda px: _pil_file(Image.fromarray(px), "JPEG",
                                        keep_rgb=True),
        "adam7.png": lambda px: encode_png(px, interlace=True),
        "deep.png": lambda px: encode_png(px.astype(np.uint16) * 300,
                                          depth=16),
        "gray2.png": lambda px: encode_png(px[..., 1] >> 6, depth=2),
        "still.gif": lambda px: _pil_file(Image.fromarray(px).quantize(32),
                                          "GIF"),
    }
    annos = []
    for i, (name, write) in enumerate(writers.items()):
        (tmp_path / name).write_bytes(write(_smooth(rng, 44, 36)))
        annos.append({"image": name, "conversations": _turns("<image>", i,
                                                             1)})
    frames = tmp_path / "frames"
    frames.mkdir()
    for f in range(5):
        px = _smooth(rng, 30, 40)
        data = (encode_jpeg(px, 80, "4:2:0", script=PROGRESSIVE) if f % 2
                else encode_png(px, interlace=True))
        (frames / f"{f:03d}.img").write_bytes(data)
    annos.append({"video": "frames", "conversations": _turns("<video>", 9,
                                                             2)})
    (tmp_path / "anno.json").write_text(json.dumps(annos))
    jds, tds = _datasets(str(tmp_path), tok, "anno.json")
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        for key in ("input_ids", "labels", "frames"):
            np.testing.assert_array_equal(got[key], want[key])


def _pil_file(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def test_dataset_stand_in_is_seeded_and_unported_formats_propagate(
        corpus, tok, tmp_path):
    """A file that fails to decode (truncated, or missing) is replaced by
    the sample random.Random(seed) draws, with a warning naming the file;
    a variant the port does not decode (a progressive JPEG whose scans
    stop short of full refinement, which libjpeg-turbo would smooth)
    raises."""
    with open(os.path.join(corpus, "sft.json")) as f:
        annos = json.load(f)
    png = open(os.path.join(corpus, "media", "i2.png"), "rb").read()
    (tmp_path / "cut.png").write_bytes(png[:60])
    (tmp_path / "prog.jpg").write_bytes(encode_jpeg(
        _smooth(np.random.default_rng(1), 16, 16), 80,
        script=PROGRESSIVE[:6]))
    for i, name in enumerate(("cut.png", "missing.png")):
        annos[i] = {"image": str(tmp_path / name),
                    "conversations": annos[i]["conversations"]}
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps(annos))
    _, tcfg = _cfgs()
    da = tdata.DataArguments(data_path=[str(anno)], data_folder=corpus)
    for i, name in enumerate(("cut.png", "missing.png")):
        ds = tdata.SupervisedDataset([str(anno)], tok, da, tcfg, seed=SEED)
        stand_in = random.Random(SEED).randint(0, len(ds) - 1)
        with pytest.warns(UserWarning, match=name):
            got = ds[i]
        want = tdata.SupervisedDataset([str(anno)], tok, da, tcfg)[stand_in]
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["frames"], want["frames"])
    annos[0] = {"image": str(tmp_path / "prog.jpg"),
                "conversations": annos[0]["conversations"]}
    anno.write_text(json.dumps(annos))
    ds = tdata.SupervisedDataset([str(anno)], tok, da, tcfg, seed=SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(NotImplementedError, match="progressive JPEG"):
            ds[0]


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_sampler_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lengths = [int(v) * (1 if rng.random() < 0.7 else -1)
               for v in rng.integers(1, 300, 61)]
    for bs in (4, 7):
        want = [list(map(int, b)) for b in
                jdata.LengthGroupedBatchSampler(bs, lengths, seed=seed)]
        got = [list(map(int, b)) for b in
               tdata.LengthGroupedBatchSampler(bs, lengths, seed=seed)]
        assert got == want and len(got) > 3


# -- the Trainer over the dataset --------------------------------------------

def _jparams():
    jcfg, _ = _cfgs()
    return jvl2.init_params(jax.random.PRNGKey(0), jcfg)


def _tparams(jparams):
    _, tcfg = _cfgs()
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


OPT = dict(learning_rate=1e-3, mm_projector_lr=1e-2, warmup_ratio=0.0)


def _tcfg_kwargs(out, grouped, **kw):
    return dict(dict(output_dir=out, per_device_batch_size=2,
                     gradient_accumulation_steps=2, num_epochs=3,
                     max_steps=3, seq_len=SEQ, save_steps=2, log_steps=1,
                     seed=SEED, group_by_modality_length=grouped,
                     compute_dtype="float32"), **kw)


def _losses(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.mark.parametrize("grouped", [False, True])
def test_trainer_steps_match_jax(corpus, tok, tmp_path, grouped, one_device):
    """Three steps of the Trainer over the dataset (2 x 2 samples a step,
    the LLM and projector trained) give JAX's losses; without grouping,
    JAX's resume is pinned: a Trainer resumed at its last step trains
    epoch 0's first batch again (the port skips it: see
    test_resume_matches_the_uninterrupted_run)."""
    jds, tds = _datasets(corpus, tok, "sft.json")
    jcfg, tcfg = _cfgs()
    jp = _jparams()
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = jtrainer.Trainer(jcfg, jp, jds, jopt.OptimizerConfig(**OPT),
                          jtrainer.TrainerConfig(**_tcfg_kwargs(jout,
                                                                grouped)))
    jt.train()
    tt = Trainer(tcfg, _tparams(jp), topt.OptimizerConfig(**OPT),
                 TrainerConfig(**_tcfg_kwargs(tout, grouped)), device="cpu",
                 dataset=tds)
    tt.train()
    want, got = _losses(jout), _losses(tout)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert sorted(os.listdir(os.path.join(tout, "checkpoints"))) == ["2",
                                                                     "3"]
    if grouped:
        return
    # JAX's replay: the resumed Trainer's batch is epoch 0's first
    jt2 = jtrainer.Trainer(jcfg, _jparams(), jds, jopt.OptimizerConfig(**OPT),
                           jtrainer.TrainerConfig(**_tcfg_kwargs(
                               jout, grouped, max_steps=4)))
    assert jt2.start_step == 3
    seen = []

    def record(state, batch):
        # the batch JAX's loop feeds its step, without compiling the step
        seen.append(batch)
        return state, {"loss": 0.0, "accuracy": 0.0, "num_tokens": 0}
    jt2.step_fn = record
    jt2.train()
    first = next(jt2._batch_iterator(0))
    np.testing.assert_array_equal(np.asarray(seen[0].text_ids),
                                  np.asarray(first.text_ids))
    port_next = tt.collator([tds[int(i)] for i in list(tt._index_batches(1))
                             [0]])
    assert not np.array_equal(port_next.text_ids, first.text_ids)


@pytest.fixture(scope="module")
def uninterrupted(corpus, tok, tmp_path_factory):
    """Four port steps over pre.json (projector only), saved at 2 and 4."""
    _, tds = _datasets(corpus, tok, "pre.json", is_pretraining=True)
    out = str(tmp_path_factory.mktemp("uninterrupted"))
    t = _pretrain_trainer(out, tds)
    state = t.train()
    return state, _losses(out)


def _pretrain_trainer(out, tds):
    _, tcfg = _cfgs()
    return Trainer(tcfg, _tparams(_jparams()),
                   topt.OptimizerConfig(learning_rate=1e-3,
                                        tune_mm_mlp_adapter=True),
                   TrainerConfig(**_tcfg_kwargs(out, False, max_steps=4,
                                                num_epochs=2)),
                   device="cpu", dataset=tds)


def _assert_same_state(got, want):
    for (p, t), (q, u) in zip(topt.flatten(got.params).items(),
                              topt.flatten(want.params).items()):
        assert p == q and torch.equal(t, u), p
    for moment in ("mu", "nu", "master"):
        assert set(got.opt_state[moment]) == set(want.opt_state[moment])
        for p, t in want.opt_state[moment].items():
            assert torch.equal(got.opt_state[moment][p], t), p
    assert got.opt_state["count"] == want.opt_state["count"]
    assert got.step == want.step


def test_resume_matches_the_uninterrupted_run(corpus, tok, tmp_path,
                                              uninterrupted):
    """A run killed after its step-2 save and resumed in a new Trainer
    reaches the uninterrupted run's state at step 4 bit for bit: the
    resumed steps train the batches the uninterrupted run trained."""
    want_state, want_losses = uninterrupted
    _, tds = _datasets(corpus, tok, "pre.json", is_pretraining=True)
    out = str(tmp_path / "run")
    t = _pretrain_trainer(out, tds)
    inner = t.step_fn

    def dies_at_step_3(state, batch):
        if state.step == 2:
            raise KeyboardInterrupt("killed")
        return inner(state, batch)
    t.step_fn = dies_at_step_3
    with pytest.raises(KeyboardInterrupt):
        t.train()
    assert train_state.latest_step(os.path.join(out, "checkpoints")) == 2
    t2 = _pretrain_trainer(out, tds)
    assert t2.start_step == 2
    _assert_same_state(t2.train(), want_state)
    assert _losses(out) == want_losses


def test_sigterm_saves_at_the_step_and_resumes(corpus, tok, tmp_path,
                                               uninterrupted):
    """SIGTERM during step 2 lets the step finish, saves at step 2
    (adapter-2/ and checkpoints/2/) and returns; a new Trainer resumes
    there and ends where the uninterrupted run does."""
    want_state, _ = uninterrupted
    _, tds = _datasets(corpus, tok, "pre.json", is_pretraining=True)
    out = str(tmp_path / "run")
    t = _pretrain_trainer(out, tds)
    inner = t.step_fn

    def signalled(state, batch):
        if state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(state, batch)
    t.step_fn = signalled
    before = signal.getsignal(signal.SIGTERM)
    state = t.train()
    assert state.step == 2
    assert signal.getsignal(signal.SIGTERM) is before
    assert sorted(os.listdir(out)) == ["adapter-2", "checkpoints",
                                       "train_log.jsonl"]
    t2 = _pretrain_trainer(out, tds)
    assert t2.start_step == 2
    _assert_same_state(t2.train(), want_state)


def test_train_state_round_trips_and_keeps_three(tmp_path):
    """The saved state reads back bit for bit (bf16 and fp32 params, the
    fp32 master of a bf16 param, fp32 moments over a bf16 template keep
    their dtype), a leftover temporary directory is ignored, and only the
    newest 3 steps stay."""
    g = torch.Generator().manual_seed(0)

    def state(step):
        params = {"connector": {"w": torch.randn(3, 4, generator=g)},
                  "llm": {"e": torch.randn(5, generator=g).bfloat16()}}
        opt = {"count": {"projector": step},
               "mu": {("connector", "w"): torch.randn(3, 4, generator=g)},
               "nu": {("connector", "w"): torch.rand(3, 4, generator=g)},
               "master": {("llm", "e"): torch.randn(5, generator=g)}}
        return tstep.TrainState(params=params, opt_state=opt, step=step)
    d = str(tmp_path / "checkpoints")
    saved = {}
    for step in range(1, 6):
        saved[step] = state(step)
        train_state.save_train_state(d, saved[step])
    os.makedirs(os.path.join(d, ".6-partial"))
    assert sorted(os.listdir(d)) == [".6-partial", "3", "4", "5"]
    assert train_state.latest_step(d) == 5
    template = state(0)
    template.opt_state["mu"] = {("connector", "w"): torch.zeros(
        3, 4, dtype=torch.bfloat16)}
    got = train_state.restore_train_state(d, template, 4)
    assert got.opt_state["mu"][("connector", "w")].dtype == torch.float32
    _assert_same_state(got, saved[4])
    with pytest.raises(FileNotFoundError):
        train_state.restore_train_state(str(tmp_path / "none"), template)


def test_export_hf_projector_bin_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    jp = _jparams()
    conn = _tparams(jp)["connector"]
    jorbax.export_hf_projector_bin(str(tmp_path / "j.bin"), jp["connector"],
                                   jcfg)
    projector_io.export_hf_projector_bin(
        str(tmp_path / "mm_projector.bin"), conn)
    want = torch.load(str(tmp_path / "j.bin"), weights_only=True)
    got = torch.load(str(tmp_path / "mm_projector.bin"), weights_only=True)
    assert sorted(got) == sorted(want) and len(want) > 10
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    back = tconv.load_pretrain_adapter(str(tmp_path), tcfg.connector)
    for p, t in topt.flatten(back).items():
        assert torch.equal(t, topt.flatten(conn)[p]), p


# -- main() ------------------------------------------------------------------

def test_argparse_options_match_jax():
    def options(ap):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.nargs, a.required)
                for a in ap._actions if a.dest != "help"}
    want = options(jtrain.build_argparser())
    got = options(ttrain.build_argparser())
    assert set(got) - set(want) == {"tokenizer", "device"}
    for k, v in want.items():
        assert got[k][:2] == v[:2] and got[k][3:] == v[3:], k
        assert (got[k][2] is None) == (v[2] is None), k


def _flags(ckpt, corpus, out, stage, model_type="videollama2_mistral"):
    """pretrain.sh's (stage 1) or finetune.sh's (stage 2) flags, sized for
    the tiny model: 2 x 2 samples a step, one step, fp32."""
    common = ["--model_type", model_type, "--model_path", ckpt,
              "--mm_vision_select_layer", "-2", "--data_folder", corpus,
              "--num_frames", "8", "--model_max_length", "512",
              "--output_dir", out, "--num_train_epochs", "1",
              "--per_device_train_batch_size", "2",
              "--gradient_accumulation_steps", "2",
              "--weight_decay", "0.", "--warmup_ratio", "0.03",
              "--lr_scheduler_type", "cosine", "--save_steps", "500",
              "--logging_steps", "1", "--bf16", "false", "--max_steps", "1",
              "--seed", str(SEED), "--mesh_fsdp", "-1", "--mesh_tensor", "1"]
    if stage == 1:
        return common + ["--tune_mm_mlp_adapter", "true", "--data_path",
                         os.path.join(corpus, "pre.json"),
                         "--learning_rate", "1e-3"]
    return common + ["--image_aspect_ratio", "pad", "--data_path",
                     os.path.join(corpus, "sft.json"),
                     "--learning_rate", "2e-5",
                     "--group_by_modality_length", "true"]


def _run_jax(monkeypatch, flags):
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    jtrain.main()


def _run_port(flags):
    return ttrain.main(flags + ["--tokenizer", TOKENIZER, "--device", "cpu"])


def _projector(out):
    return dict(np.load(os.path.join(out, "mm_projector.npz")))


def test_main_pretrain_and_finetune_match_jax(ckpt, corpus, tmp_path,
                                              monkeypatch, one_device):
    """pretrain.sh's flags on the tiny full checkpoint: the first step's
    loss and the saved adapter-1/ equal JAX's; finetune.sh's flags over
    that adapter (--pretrain_mm_mlp_adapter, --group_by_modality_length,
    the LLM trained): the first step's loss equals JAX's."""
    j1, t1 = str(tmp_path / "j1"), str(tmp_path / "t1")
    _run_jax(monkeypatch, _flags(ckpt, corpus, j1, 1))
    trainer = _run_port(_flags(ckpt, corpus, t1, 1))
    assert trainer.state.step == 1
    np.testing.assert_allclose(_losses(t1), _losses(j1), rtol=LOSS_RTOL)
    want = _projector(os.path.join(j1, "adapter-1"))
    got = _projector(os.path.join(t1, "adapter-1"))
    assert sorted(got) == sorted(want)
    for k in want:
        tol = 1e-5 * np.abs(want[k]).max() + PARAM_LR_FRAC * 1e-3
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
    j2, t2 = str(tmp_path / "j2"), str(tmp_path / "t2")
    adapter = ["--pretrain_mm_mlp_adapter", os.path.join(j1, "adapter-1")]
    _run_jax(monkeypatch, _flags(ckpt, corpus, j2, 2) + adapter)
    _run_port(_flags(ckpt, corpus, t2, 2) + adapter)
    np.testing.assert_allclose(_losses(t2), _losses(j2), rtol=LOSS_RTOL)


def test_main_without_tokenizer_flag_builds_jax_ids(ckpt, corpus, tmp_path,
                                                    monkeypatch):
    """finetune.sh's flags with no --tokenizer: train.py reads
    --model_path's own tokenizer files (multimodal/hf_tokenizer.py), and
    its dataset's ids and labels equal those of JAX's dataset, whose
    train.py reads the directory with AutoTokenizer."""
    from videollama2_tpu_torch.multimodal import hf_tokenizer
    built = []
    orig = tdata.SupervisedDataset.__init__

    def record(self, *a, **kw):
        orig(self, *a, **kw)
        built.append(self)
    monkeypatch.setattr(tdata.SupervisedDataset, "__init__", record)
    trainer = ttrain.main(_flags(ckpt, corpus, str(tmp_path / "t"), 2)
                          + ["--device", "cpu"])
    assert trainer.state.step == 1
    (tds,) = built
    assert isinstance(tds.tokenizer, hf_tokenizer.HFTokenizer)
    jcfg, _ = _cfgs()
    path = [os.path.join(corpus, "sft.json")]
    jds = jdata.SupervisedDataset(
        path, hf_tokenizer_reference(ckpt),
        jdata.DataArguments(data_path=path, data_folder=corpus,
                            is_pretraining=False), jcfg)
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        for key in ("input_ids", "labels"):
            np.testing.assert_array_equal(tds[i][key], jds[i][key])


def hf_tokenizer_reference(path):
    """JAX train.py's tokenizer (pad -> unk as there)."""
    tok = hf_tokenizer(path)
    if tok.pad_token is None and tok.unk_token is not None:
        tok.pad_token = tok.unk_token
    return tok


def test_main_bf16_keeps_fp32_masters_and_matches_jax(ckpt, corpus, tmp_path,
                                                     monkeypatch, one_device):
    """pretrain.sh's flags with --bf16 true (its default): the model runs in
    bf16, the connector trains on fp32 masters with fp32 moments, and the
    saved adapter-1/ (the masters) holds JAX's update, whose params stay
    fp32 as loaded: no update is lost below bf16's half ulp."""
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    jflags, tflags = _flags(ckpt, corpus, j, 1), _flags(ckpt, corpus, t, 1)
    for flags in (jflags, tflags):
        flags[flags.index("--bf16") + 1] = "true"
    _run_jax(monkeypatch, jflags)
    trainer = _run_port(tflags)
    np.testing.assert_allclose(_losses(t), _losses(j), rtol=BF16_LOSS_RTOL)
    state = trainer.state
    masters = state.opt_state["master"]
    conn = {p: v for p, v in topt.flatten(state.params).items()
            if p[0] == "connector"}
    assert set(masters) == set(conn)
    assert {v.dtype for v in topt.flatten(state.params).values()
            if v.is_floating_point()} == {torch.bfloat16}
    for p, m in masters.items():
        assert m.dtype == torch.float32
        assert state.opt_state["mu"][p].dtype == torch.float32
        assert state.opt_state["nu"][p].dtype == torch.float32
        assert torch.equal(m.to(torch.bfloat16), conn[p]), p
    want = _projector(os.path.join(j, "adapter-1"))
    got = _projector(os.path.join(t, "adapter-1"))
    assert sorted(got) == sorted(want)
    lr = 1e-3
    for k in want:
        near = np.abs(got[k] - want[k]) <= 1e-5 * np.abs(want[k]).max() \
            + PARAM_LR_FRAC * lr
        assert near.mean() >= BF16_UPDATES_NEAR, (k, near.mean())


def _qwen2_checkpoint(d):
    """A tiny full VideoLLaMA2.1 checkpoint in the released key layout:
    Qwen2 (14 query heads on 2 kv heads of 8), SigLIP, STCv35."""
    import transformers
    from safetensors.numpy import save_file
    from test_connector_parity import TorchSTC
    from make_tiny_checkpoint import build_tokenizer

    cfg = jcfglib.tiny_model("videollama2_qwen2")
    lc = dataclasses.replace(cfg.llm, num_heads=14, num_kv_heads=2,
                             head_dim=8)
    vc = cfg.vision
    torch.manual_seed(0)
    llm = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=lc.vocab_size, hidden_size=lc.hidden_size,
        intermediate_size=lc.intermediate_size,
        num_hidden_layers=lc.num_layers, num_attention_heads=lc.num_heads,
        num_key_value_heads=lc.num_kv_heads, head_dim=lc.head_dim,
        rope_theta=lc.rope_theta, rms_norm_eps=lc.rms_norm_eps,
        tie_word_embeddings=False))
    tower = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=vc.hidden_size, intermediate_size=vc.intermediate_size,
        num_hidden_layers=vc.num_layers, num_attention_heads=vc.num_heads,
        image_size=vc.image_size, patch_size=vc.patch_size,
        layer_norm_eps=vc.layer_norm_eps, hidden_act=vc.hidden_act))
    sd = {k: v.numpy() for k, v in llm.state_dict().items()}
    sd.update({f"model.vision_tower.vision_tower.{k}": v.numpy()
               for k, v in tower.state_dict().items()})
    sd.update({f"model.mm_projector.{k}": v.numpy()
               for k, v in TorchSTC(cfg.connector).state_dict().items()})
    os.makedirs(d, exist_ok=True)
    save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "model_type": "videollama2_qwen2", "vocab_size": lc.vocab_size,
            "hidden_size": lc.hidden_size,
            "intermediate_size": lc.intermediate_size,
            "num_hidden_layers": lc.num_layers,
            "num_attention_heads": lc.num_heads,
            "num_key_value_heads": lc.num_kv_heads, "head_dim": lc.head_dim,
            "rope_theta": lc.rope_theta, "rms_norm_eps": lc.rms_norm_eps,
            "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 0,
            "mm_projector_type": cfg.connector.projector_type,
            "mm_hidden_size": cfg.connector.mm_hidden_size,
            "mm_vision_tower": "tiny-siglip-test",
            "mm_vision_select_layer": -2,
            "mm_connector_depth": cfg.connector.depth,
            "num_frames": cfg.num_frames,
            "tiny_test_vision": {
                "image_size": vc.image_size, "patch_size": vc.patch_size,
                "hidden_size": vc.hidden_size,
                "intermediate_size": vc.intermediate_size,
                "num_layers": vc.num_layers, "num_heads": vc.num_heads}}, f)
    build_tokenizer(d, lc.vocab_size)
    return d


def test_main_qwen2_matches_jax(corpus, tmp_path, monkeypatch, one_device):
    """--model_type videollama2_qwen2 (SigLIP + STCv35 + Qwen2 at 7 query
    heads a kv head): the first step's loss equals JAX's."""
    ckpt = _qwen2_checkpoint(str(tmp_path / "qwen2"))
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    _run_jax(monkeypatch, _flags(ckpt, corpus, j, 1, "videollama2_qwen2"))
    trainer = _run_port(_flags(ckpt, corpus, t, 1, "videollama2_qwen2"))
    assert trainer.model_cfg.llm.num_heads // \
        trainer.model_cfg.llm.num_kv_heads == 7
    np.testing.assert_allclose(_losses(t), _losses(j), rtol=LOSS_RTOL)


def test_main_lora_qlora_and_bin_adapter_run(ckpt, corpus, tmp_path):
    """--lora_enable --bits 4 (QLoRA over folded int4 layers) with
    finetune.sh's flags, the projector from an mm_projector.bin that
    export_hf_projector_bin wrote, runs a step and saves lora-1/."""
    _, tcfg = _cfgs()
    conn = _tparams(_jparams())["connector"]
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    projector_io.export_hf_projector_bin(str(bin_dir / "mm_projector.bin"),
                                         conn)
    out = str(tmp_path / "lora")
    trainer = _run_port(_flags(ckpt, corpus, out, 2) + [
        "--lora_enable", "true", "--bits", "4", "--lora_r", "4",
        "--lora_alpha", "8", "--pretrain_mm_mlp_adapter", str(bin_dir)])
    layers = trainer.state.params["llm"]["layers"]
    assert "kernel_q4" in layers["qkv"] and "lora" in layers["down"]
    assert np.isfinite(_losses(out)).all()
    assert "lora-1" in os.listdir(out)
    loaded = tconv.load_pretrain_adapter(str(bin_dir), tcfg.connector)
    for p, t in topt.flatten(loaded).items():
        assert torch.equal(t, topt.flatten(conn)[p]), p


def _plain_dirs(ckpt, root):
    """The tiny checkpoint split into a plain Mistral directory (the LLM's
    keys, an HF config.json and the tokenizer) and a CLIP tower directory
    (vision_model.* and its HF config.json)."""
    from make_tiny_checkpoint import build_tokenizer
    from safetensors.numpy import load_file, save_file
    sd = load_file(os.path.join(ckpt, "model.safetensors"))
    with open(os.path.join(ckpt, "config.json")) as f:
        cj = json.load(f)
    llm_dir, tower_dir = os.path.join(root, "llm"), os.path.join(root, "clip")
    os.makedirs(llm_dir)
    os.makedirs(tower_dir)
    tp = "model.vision_tower.vision_tower."
    save_file({k: v for k, v in sd.items() if not k.startswith(
        (tp, "model.mm_projector."))}, os.path.join(llm_dir,
                                                    "model.safetensors"))
    llm_json = {k: v for k, v in cj.items() if not k.startswith(("mm_",
                                                                "tiny"))}
    llm_json.update(model_type="mistral",
                    architectures=["MistralForCausalLM"])
    with open(os.path.join(llm_dir, "config.json"), "w") as f:
        json.dump(llm_json, f)
    build_tokenizer(llm_dir, cj["vocab_size"])
    save_file({k[len(tp):]: v for k, v in sd.items() if k.startswith(tp)},
              os.path.join(tower_dir, "model.safetensors"))
    tv = cj["tiny_test_vision"]
    with open(os.path.join(tower_dir, "config.json"), "w") as f:
        json.dump({"model_type": "clip_vision_model",
                   "hidden_size": tv["hidden_size"],
                   "intermediate_size": tv["intermediate_size"],
                   "num_hidden_layers": tv["num_layers"],
                   "num_attention_heads": tv["num_heads"],
                   "image_size": tv["image_size"],
                   "patch_size": tv["patch_size"],
                   "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5}, f)
    return llm_dir, tower_dir


def test_vision_tower_flag_loads_the_directory(ckpt, corpus, tmp_path,
                                               monkeypatch):
    """The plain-LLM branch with --vision_tower DIR trains over that
    tower; a name that is no local directory raises. JAX's main parses the
    flag and never reads it: its tower is vit.init_params (pinned, with
    its preset cut to the tiny model so the tiny LLM loads)."""
    llm_dir, tower_dir = _plain_dirs(ckpt, str(tmp_path))
    flags = _flags(llm_dir, corpus, str(tmp_path / "t"), 1) + [
        "--mm_projector_type", "stc_connector_v35"]
    trainer = _run_port(flags + ["--vision_tower", tower_dir])
    _, tcfg = _cfgs()
    vision = tconv.vision_params_from_state_dict(
        tconv.load_state_dict_from_dir(tower_dir), tcfg.vision)
    got = trainer.state.params["vision"]
    assert torch.equal(got["patch_embed"]["kernel"],
                       vision["patch_embed"]["kernel"])
    assert torch.equal(got["layers"]["qkv"]["kernel"], torch.cat(
        [vision["layers"][n]["kernel"] for n in "qkv"], dim=-1))
    assert trainer.model_cfg.vision.hidden_size == tcfg.vision.hidden_size
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        _run_port(flags + ["--vision_tower",
                           "openai/clip-vit-large-patch14-336"])

    captured = {}

    class Capture:
        def __init__(self, cfg, params, *args, **kwargs):
            captured.update(cfg=cfg, params=params)

        def train(self):
            pass
    monkeypatch.setattr(jtrainer, "Trainer", Capture)
    monkeypatch.setattr(jcfglib, "preset", lambda name: jcfglib.tiny_model(
        name))
    _run_jax(monkeypatch, flags + ["--vision_tower", tower_dir])
    jv = captured["params"]["vision"]
    init = jvit.init_params(jax.random.PRNGKey(SEED),
                            captured["cfg"].vision)
    np.testing.assert_array_equal(np.asarray(jv["patch_embed"]["kernel"]),
                                  np.asarray(init["patch_embed"]["kernel"]))
    assert not np.array_equal(np.asarray(jv["patch_embed"]["kernel"]),
                              vision["patch_embed"]["kernel"].numpy())


@pytest.mark.parametrize("flag", ["--mesh_data", "--mesh_tensor",
                                  "--mesh_seq", "--mesh_fsdp"])
def test_mesh_degrees_above_one_raise(flag, tmp_path, monkeypatch):
    """Without torchrun (no process group) a degree above one raises,
    naming the launch (tests/test_torch_parallel.py runs it)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        ttrain.main(["--model_path", str(tmp_path), "--data_path", "a.json",
                     "--output_dir", str(tmp_path), flag, "2",
                     "--device", "cpu"])
