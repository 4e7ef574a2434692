"""The port's copies of the JAX package's host modules (core/config.py,
constants.py, media/wire.py, media/audio.py, multimodal/tokenizer.py,
inference/speculative.py, utils/logging.py, and the byte-identical
media/sampler.py, media/prefetch.py, media/csrc/video_decoder.cc,
serve/controller.py, serve/register_worker.py and serve/test_message.py)
against the originals: every preset and tiny config field by field, the
derived token counts, the token, serving and frame constants, the I420
pack/unpack on a seeded frame, the fbank front end's constants, mel banks
and features on a seeded waveform, the modal-token splitters and
model-name helper on a seeded word-level tokenizer, the prompt-lookup
drafts and greedy acceptance on seeded token streams, the copied files
byte for byte, the logging helpers' source, and the prefetcher's order,
back-pressure and error propagation."""

import dataclasses
import inspect
import time
from pathlib import Path

import numpy as np
import pytest

from videollama2_tpu import constants as jconst
from videollama2_tpu.core import config as jcfg
from videollama2_tpu.inference import speculative as jspec
from videollama2_tpu.media import audio as jaudio
from videollama2_tpu.media import wire as jwire
from videollama2_tpu.multimodal import tokenizer as jtok
from videollama2_tpu.utils import logging as jlogging
from videollama2_tpu.utils import misc as jmisc
from videollama2_tpu_torch import constants as tconst
from videollama2_tpu_torch.core import config as tcfg
from videollama2_tpu_torch.inference import speculative as tspec
from videollama2_tpu_torch.media import audio as taudio
from videollama2_tpu_torch.media import wire as twire
from videollama2_tpu_torch.multimodal import tokenizer as ttok
from videollama2_tpu_torch.media.prefetch import prefetch_map
from videollama2_tpu_torch.utils import logging as tlogging
from videollama2_tpu_torch.utils import misc as tmisc

ROOT = Path(__file__).resolve().parent.parent

PRESETS = sorted(jcfg._PRESETS)


def test_same_presets():
    assert sorted(tcfg._PRESETS) == PRESETS


def _configs(name):
    if name.startswith("tiny:"):
        _, model_type, projector = name.split(":")
        return (jcfg.tiny_model(model_type, projector),
                tcfg.tiny_model(model_type, projector))
    return jcfg.preset(name), tcfg.preset(name)


@pytest.mark.parametrize("name", PRESETS + [
    "tiny:videollama2_mistral:stc_connector_v35",
    "tiny:videollama2_mistral:stc_connector",
    "tiny:videollama2_qwen2:stc_connector_v35"])
def test_config_fields_and_derived_counts(name):
    j, t = _configs(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for frames in (8, 16):
        assert (t.replace(num_frames=frames).tokens_per_video
                == j.replace(num_frames=frames).tokens_per_video)
    assert t.vision.seq_len == j.vision.seq_len
    assert t.vision.head_dim == j.vision.head_dim
    assert t.connector.conv_padding == j.connector.conv_padding
    assert t.llm.is_moe == j.llm.is_moe


@pytest.mark.parametrize("fn,kw", [
    ("tiny_llm", dict(model_type="mistral")),
    ("tiny_llm", dict(model_type="qwen2", vocab_size=300)),
    ("tiny_vision", dict(variant="clip")),
    ("tiny_vision", dict(variant="siglip")),
])
def test_tiny_parts(fn, kw):
    assert (dataclasses.asdict(getattr(tcfg, fn)(**kw))
            == dataclasses.asdict(getattr(jcfg, fn)(**kw)))


def test_connector_token_counts():
    for pt in ("stc_connector", "stc_connector_v35", "spatial_conv",
               "stp_connector", "spatial_pool", "identity", "mlp2x_gelu",
               "linear"):
        jc = jcfg.ConnectorConfig(projector_type=pt)
        tc = tcfg.ConnectorConfig(projector_type=pt)
        for t, hw in ((8, 24), (16, 24), (4, 27)):
            assert (tcfg.connector_output_tokens(tc, t, hw)
                    == jcfg.connector_output_tokens(jc, t, hw))
    assert tcfg.conv3d_out(24, 2, 2, 1) == jcfg.conv3d_out(24, 2, 2, 1)


def test_constants():
    for name in ("IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "VIDEO_TOKEN_INDEX",
                 "AUDIO_TOKEN_INDEX", "MODAL_INDEX_MAP", "DEFAULT_IMAGE_TOKEN",
                 "DEFAULT_VIDEO_TOKEN", "DEFAULT_AUDIO_TOKEN",
                 "CONTROLLER_HEART_BEAT_EXPIRATION",
                 "WORKER_HEART_BEAT_INTERVAL", "LOGDIR", "NUM_FRAMES",
                 "MAX_FRAMES", "NUM_FRAMES_PER_SECOND"):
        assert getattr(tconst, name) == getattr(jconst, name), name


def test_wire_pack_and_unpack():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (2, 3, 56, 40, 3), dtype=np.uint8)
    for name in ("INV_R_CR", "INV_G_CB", "INV_G_CR", "INV_B_CB"):
        assert getattr(twire, name) == getattr(jwire, name)
    packed = twire.rgb_to_i420(rgb)
    np.testing.assert_array_equal(packed, jwire.rgb_to_i420(rgb))
    np.testing.assert_array_equal(twire.i420_to_rgb(packed),
                                  jwire.i420_to_rgb(packed))


def test_audio_front_end():
    """The fbank copy (tests/test_torch_audio.py holds it on more
    waveforms and the .wav reader): constants, mel banks at the BEATs and
    at another rate, and the features of a seeded 2 s waveform."""
    for name in ("SAMPLE_RATE", "FRAME_LENGTH_MS", "FRAME_SHIFT_MS",
                 "NUM_MEL_BINS", "LOW_FREQ", "PREEMPH", "FBANK_MEAN",
                 "FBANK_STD"):
        assert getattr(taudio, name) == getattr(jaudio, name), name
    for args in ((128, 512, 16000), (64, 1024, 44100)):
        np.testing.assert_array_equal(taudio.mel_banks(*args),
                                      jaudio.mel_banks(*args))
    wav = np.random.default_rng(6).uniform(-0.5, 0.5, 32000)
    np.testing.assert_array_equal(taudio.beats_preprocess(wav),
                                  jaudio.beats_preprocess(wav))
    assert taudio._next_pow2(400) == jaudio._next_pow2(400) == 512
    np.testing.assert_array_equal(taudio._povey_window(400),
                                  jaudio._povey_window(400))


class _Encoded:
    def __init__(self, ids):
        self.input_ids = ids


class WordTokenizer:
    """A word-level tokenizer over a seeded vocabulary (whitespace split,
    unknown words to id 0), with the call signature the splitters use."""

    def __init__(self, words):
        self.vocab = {w: i + 3 for i, w in enumerate(words)}

    def __call__(self, text, add_special_tokens=True):
        ids = [self.vocab.get(w, 0) for w in text.split()]
        return _Encoded(([1] if add_special_tokens else []) + ids)


def _seeded_prompts(seed):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)]
    tags = ["<video>", "<image>", "<audio>"]
    prompts = []
    for _ in range(12):
        parts = rng.choice(words + tags, size=rng.integers(0, 14))
        prompts.append(" ".join(parts) + rng.choice(["", " ", "<video>"]))
    return WordTokenizer(words), prompts + ["", "<video>", "<video><audio>"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenizer_splitters(seed):
    tok, prompts = _seeded_prompts(seed)
    for prompt in prompts:
        for tag in ("<video>", "<image>", "<audio>", "", "<none>"):
            assert (ttok.tokenizer_multimodal_token(prompt, tok, tag)
                    == jtok.tokenizer_multimodal_token(prompt, tok, tag))
        np.testing.assert_array_equal(
            ttok.tokenizer_multimodal_token(prompt, tok, "<video>", "np"),
            jtok.tokenizer_multimodal_token(prompt, tok, "<video>", "np"))
        for tags in (("<video>", "<audio>"), ("<image>",), ("<audio>",)):
            assert (ttok.tokenizer_multimodal_tokens(prompt, tok, tags)
                    == jtok.tokenizer_multimodal_tokens(prompt, tok, tags))
    with pytest.raises(ValueError):
        ttok.tokenizer_multimodal_token("a", tok, "<video>", "pt")


def test_model_name_from_path():
    for path in ("/ckpts/VideoLLaMA2-7B-16F", "VideoLLaMA2-7B-16F/",
                 "runs/vl2/checkpoint-1200", "/a/b/checkpoint-5/",
                 "model"):
        assert (ttok.get_model_name_from_path(path)
                == jtok.get_model_name_from_path(path))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_drafts_and_acceptance(seed):
    """ngram_propose on seeded streams over a small alphabet (so n-grams
    recur), at every k and n range the Engines use and a few more, and
    accept_drafts on drafts that agree with the greedy ids for a seeded
    stretch."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ctx = [int(t) for t in rng.integers(0, 6, rng.integers(0, 30))]
        for k in (0, 1, 3, 7):
            for max_n, min_n in ((3, 1), (2, 1), (4, 2)):
                assert (tspec.ngram_propose(ctx, k, max_n, min_n)
                        == jspec.ngram_propose(ctx, k, max_n, min_n))
        k = int(rng.integers(1, 6))
        greedy = [int(t) for t in rng.integers(0, 6, k)]
        drafts = greedy[:int(rng.integers(0, k))] + [int(t) for t in
                                                     rng.integers(0, 6, k)]
        drafts = drafts[:k - 1]
        assert (tspec.accept_drafts(drafts, greedy)
                == jspec.accept_drafts(drafts, greedy))


@pytest.mark.parametrize("rel", [
    "media/sampler.py", "media/prefetch.py", "media/csrc/video_decoder.cc",
    "serve/controller.py", "serve/register_worker.py",
    "serve/test_message.py", "multimodal/conversation.py", "eval/common.py",
    "eval/gpt_judge.py", "eval/eval_video_mcqa_mvbench.py",
    "eval/eval_video_mcqa_videomme.py", "eval/batch_runner.py"])
def test_copied_files_are_byte_identical(rel):
    """These files import nothing of JAX; the port keeps its own copies
    (their relative imports resolve in the port's package)."""
    assert (ROOT / "videollama2_tpu_torch" / rel).read_bytes() == \
        (ROOT / "videollama2_tpu" / rel).read_bytes()


@pytest.mark.parametrize("name", ["build_logger", "pretty_print_semaphore"])
def test_logging_helpers(name):
    assert inspect.getsource(getattr(tlogging, name)) == \
        inspect.getsource(getattr(jlogging, name))


@pytest.mark.parametrize("name", ["violates_moderation", "KeywordsStopper"])
def test_misc_helpers(name):
    """utils/misc.py's moderation hook and keyword stopper, without the
    JAX package's apply_platform_env (a TPU platform workaround)."""
    assert inspect.getsource(getattr(tmisc, name)) == \
        inspect.getsource(getattr(jmisc, name))
    assert not hasattr(tmisc, "apply_platform_env")


def test_prefetch_order_errors_and_empty():
    def work(x):
        time.sleep(0.002 * (5 - x % 5))  # out-of-order completion
        if x == 13:
            raise ValueError("boom")
        return x * 2

    assert list(prefetch_map(range(10), work, buffer_size=4,
                             num_workers=4)) == [x * 2 for x in range(10)]
    with pytest.raises(ValueError, match="boom"):
        list(prefetch_map(range(20), work, buffer_size=2, num_workers=2))
    assert list(prefetch_map([], lambda x: x)) == []
