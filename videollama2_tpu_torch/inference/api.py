"""Public inference API: model_init / mm_infer / mm_infer_batch (port of
videollama2_tpu/inference/api.py).

The same call signatures, prompt construction (including the Llama2-style
<<SYS>> system prompt of the mistral/mixtral model types), modal-token
tokenization, processors, generation defaults and decode as the JAX
package, on the port's Engine. The port imports no tokenizer or image
library, so:

* `model_init` takes the caller's tokenizer object (`tokenizer=`, e.g.
  `transformers.AutoTokenizer.from_pretrained(model_path)`); any object
  with `__call__(text, add_special_tokens=False).input_ids`,
  `apply_chat_template`, `decode` and `eos_token_id` will do. The serving
  entry points name a factory for it (`load_tokenizer`).
* The processors decode with the port's own readers (media/): PNG, PPM and
  BMP images and frame directories everywhere, video containers and their
  audio tracks through the C++ libavcodec decoder where it builds; JPEG
  and GIF raise NotImplementedError. Their resize is torch's antialiased
  bicubic, within 1 level of the JAX package's PIL pixels on downscales.

`mm_infer` takes frames as the processors give them: uint8 RGB, planar
I420 uint8 (wire="i420") or float32 (normalized). On the audio-visual
model (VideoLLaMA2.1-AV, cfg.audio set) the "audio" modal takes a .wav or
container path, a 16 kHz waveform or BEATs fbank features, and "av" a
container path (its frames and its own audio track) or a dict {"video":
frames, "audio": one of those}; `mm_infer_batch` stays video and image
only, as in the JAX package. `ChatSession`, `SessionStore` and
`mm_infer_session` serve multi-turn chat in every modal from a
prefix-cached KV (Engine.generate_continue).
"""

from __future__ import annotations

import copy
import functools
import hashlib
import importlib
import threading
import warnings
from dataclasses import dataclass
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..checkpoint import convert_hf
from ..checkpoint.from_jax import params_from_jax
from ..constants import (DEFAULT_AUDIO_TOKEN, DEFAULT_IMAGE_TOKEN,
                         DEFAULT_VIDEO_TOKEN, NUM_FRAMES)
from ..core import config as cfglib
from ..core.config import ModelConfig
from ..media import audio as audio_lib
from ..media import wire as wire_lib
from ..media.preprocess import (process_image, process_video,
                                process_video_i420)
from ..multimodal.tokenizer import (tokenizer_multimodal_token,
                                    tokenizer_multimodal_tokens)
from ..ops import quant
from ..utils.synthetic import synthetic_params
from .engine import Engine, GenerationConfig, check_device

MISTRAL_SYSTEM = (
    """<<SYS>>\nYou are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature."""
    """\n"""
    """If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.\n<</SYS>>""")

@dataclass
class VideoLLaMA2:
    """Loaded model handle (stands in for the HF nn.Module the reference
    returns from model_init)."""
    config: ModelConfig
    engine: Engine

    @property
    def model_type(self) -> str:
        return self.config.model_type


def _processors(cfg: ModelConfig, wire: str = "rgb") -> dict:
    """The processor entries of model_init (JAX model_init): "image" and
    "video" give resized uint8 RGB (normalized on the device), and on the
    audio-visual model "audio" gives [1, audio.max_frames, 128] fbank
    features and "av" a container's {"video", "audio"} (_prep_av); wire
    "i420" packs their frames (_apply_wire)."""
    num_frames = cfg.num_frames or NUM_FRAMES
    processor = {
        "image": functools.partial(process_image, cfg=cfg.vision,
                                   aspect_ratio=None, out_dtype="uint8"),
        "video": functools.partial(process_video, cfg=cfg.vision,
                                   aspect_ratio=None, num_frames=num_frames,
                                   out_dtype="uint8"),
    }
    if cfg.audio is not None:
        processor["audio"] = functools.partial(_prep_audio, cfg=cfg)
        processor["av"] = functools.partial(_prep_av, cfg=cfg,
                                            num_frames=num_frames)
    return _apply_wire(processor, wire, cfg)


def _apply_wire(processor: dict, wire: str, cfg) -> dict:
    """The I420 wire for the processors (JAX `_apply_wire`): their uint8 RGB
    packs to planar YUV 4:2:0, half the host->device bytes, unpacked on the
    device (encode_frames). A container path given to "video" alone (s, e
    and num_frames the only keywords) takes the native route
    (process_video_i420: scale and crop in YUV, no host RGB). "rgb" keeps
    the [T, H, W, 3] contract."""
    if wire == "rgb":
        return processor
    if wire != "i420":
        raise ValueError(f"wire must be 'rgb' or 'i420', got {wire!r}")

    def wrap(fn):
        def packed(*a, **k):
            out = fn(*a, **k)
            if isinstance(out, dict):  # av: {"video": ..., "audio": ...}
                return dict(out, video=wire_lib.rgb_to_i420(out["video"]))
            return wire_lib.rgb_to_i420(out)
        return packed

    def wrap_video(fn):
        nf = cfg.num_frames or NUM_FRAMES

        def packed(video_path, *a, **k):
            if (isinstance(video_path, str) and not a
                    and set(k) <= {"s", "e", "num_frames"}):
                return process_video_i420(
                    video_path, cfg.vision, s=k.get("s"), e=k.get("e"),
                    num_frames=k.get("num_frames", nf))
            return wire_lib.rgb_to_i420(fn(video_path, *a, **k))
        return packed

    out = dict(processor)
    for key in ("image", "av"):
        if key in out:
            out[key] = wrap(out[key])
    out["video"] = wrap_video(out["video"])
    return out


def load_tokenizer(spec: Optional[str], model_path: str):
    """The serving entry points' tokenizer: `spec` names a factory as
    "module:callable" (resolved with importlib at run time), called with
    the model path; e.g. a module holding `def load(path): return
    transformers.AutoTokenizer.from_pretrained(path)` and
    `--tokenizer mymodule:load`."""
    if not spec:
        raise ValueError("the port imports no tokenizer library: name a "
                         "tokenizer factory as --tokenizer module:callable "
                         "(called with the model path)")
    module, sep, attr = spec.partition(":")
    if not sep or not module or not attr:
        raise ValueError(f"--tokenizer must be module:callable, got {spec!r}")
    try:
        factory = getattr(importlib.import_module(module), attr)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"cannot resolve the tokenizer factory {spec!r}: "
                         f"{e}") from e
    return factory(model_path)


def _quantize_on_device(params: dict, device, bits: int,
                        vision: bool) -> None:
    """The JAX model_init's load_8bit / load_4bit packs, made on `device`:
    the LLM's projections as int8 (bits 8) or folded int4 (bits 4) packs
    with an int8 head, and with `vision` the tower's linears as int8 packs
    (the audio-visual model's audio branch stays floating, as in JAX).
    Each layer moves to the device and is widened to fp32 before it is
    quantized, as the JAX package quantizes the fp32 tree its loader makes,
    so the packs are the JAX package's bit for bit."""
    def prepare(t):
        return t.to(device=device, dtype=torch.float32)
    llm = params["llm"]
    quant.quantize_in_place(llm["layers"], quant.LLM_PROJECTIONS, bits,
                            prepare)
    quant.quantize_in_place(llm, ("lm_head",), 8, prepare)
    if vision:
        quant.quantize_in_place(params["vision"]["layers"],
                                quant.VISION_PROJECTIONS, 8, prepare)


def model_init(model_path: Optional[str] = None, dtype=None,
               max_len: int = 4096, model_base: Optional[str] = None,
               vision_tower_path: Optional[str] = None,
               load_8bit: bool = False, load_4bit: bool = False,
               wire: str = "rgb", tokenizer=None, device="cuda", **kwargs):
    """Load a checkpoint directory; returns (model, processor, tokenizer).

    As the JAX model_init (reference videollama2/__init__.py:14-29 and
    load_pretrained_model's LoRA, pretrain-adapter and full paths through
    model_base: a LoRA directory, the peft split save, is merged into
    model_base's kernels before load_8bit / load_4bit), plus `tokenizer`,
    the caller's tokenizer object (returned as the third element; its pad
    token falls back to its unk token), and
    `device` ("cuda" by default; "cpu" runs the plain versions of the
    kernels). load_8bit quantizes the LLM (int8 head included) and the
    tower to int8 packs, load_4bit the LLM to folded int4 packs with an
    int8 head, both on `device`. The other keyword arguments go to the
    Engine (kv_bits, buckets, decode_chunk). wire="i420" makes the
    processors give planar YUV 4:2:0 (media/wire.py); mm_infer takes both
    frame formats.
    """
    if dtype is None:
        dtype = torch.bfloat16
    if wire not in ("rgb", "i420"):  # fail before loading anything
        raise ValueError(f"wire must be 'rgb' or 'i420', got {wire!r}")
    if model_path is None:
        raise ValueError("model_path is required (no network access)")
    if tokenizer is None:
        raise ValueError("model_init needs the caller's tokenizer object "
                         "(tokenizer=..., e.g. transformers.AutoTokenizer."
                         "from_pretrained(model_path)): the port imports "
                         "no tokenizer library")
    device = check_device(device)
    if getattr(tokenizer, "pad_token", "") is None \
            and getattr(tokenizer, "unk_token", None) is not None:
        tokenizer.pad_token = tokenizer.unk_token
    if model_path.startswith("synthetic://"):
        model = _model_init_synthetic(model_path, dtype, max_len, device,
                                      **kwargs)
        return model, _processors(model.config, wire), tokenizer

    cfg, tree = convert_hf.load_videollama2(
        model_path, model_base=model_base,
        vision_tower_path=vision_tower_path)
    params = params_from_jax(tree, cfg)
    del tree
    if load_8bit or load_4bit:
        _quantize_on_device(params, device, bits=8 if load_8bit else 4,
                            vision=load_8bit)
    engine = Engine(cfg, params, dtype=dtype, max_len=max_len,
                    device=device, **kwargs)
    return (VideoLLaMA2(config=cfg, engine=engine), _processors(cfg, wire),
            tokenizer)


def _model_init_synthetic(model_path: str, dtype, max_len: int, device,
                          **kwargs) -> VideoLLaMA2:
    """model_path = 'synthetic://<preset or tiny>?bits=8&kv_bits=8
    &max_len=512&num_frames=16': the preset-scale model with seeded random
    weights made on the device (utils/synthetic; bits 8 or 4 quantize the
    LLM and the tower as bench.py does, bits 0 keeps them floating).
    Throughput numbers are real, answers are not."""
    u = urlparse(model_path)
    q = {k: v[0] for k, v in parse_qs(u.query).items()}
    cfg = (cfglib.tiny_model() if u.netloc == "tiny"
           else cfglib.preset(u.netloc))
    if "num_frames" in q:
        cfg = cfg.replace(num_frames=int(q["num_frames"]))
    bits = int(q.get("bits", "8"))
    kv_bits = int(q.get("kv_bits", kwargs.pop("kv_bits", 16)))
    max_len = int(q.get("max_len", max_len))
    params = synthetic_params(cfg, dtype=dtype, device=device, seed=0,
                              llm_bits=bits or None)
    engine = Engine(cfg, params, dtype=dtype, max_len=max_len,
                    kv_bits=kv_bits, device=device, **kwargs)
    return VideoLLaMA2(config=cfg, engine=engine)


def build_prompt_ids(instruct, cfg, tokenizer, modal: str = "video"):
    """Chat-template + multimodal-tokenize one request -> input id list
    (reference videollama2/__init__.py:72-98: modal tag prepend, the
    Llama2-style <<SYS>> system prompt for the mistral/mixtral families).
    """
    if modal == "image":
        modal_token = DEFAULT_IMAGE_TOKEN
    elif modal == "video":
        modal_token = DEFAULT_VIDEO_TOKEN
    elif modal == "audio":
        modal_token = DEFAULT_AUDIO_TOKEN
    elif modal == "av":
        # joint AV: the video tag and the audio tag of the SAME clip
        modal_token = DEFAULT_VIDEO_TOKEN + DEFAULT_AUDIO_TOKEN
    elif modal == "text":
        modal_token = ""
    else:
        raise ValueError(f"Unsupported modal: {modal}")

    if isinstance(instruct, str):
        message = [{"role": "user", "content": modal_token + "\n" + instruct}]
    elif isinstance(instruct, list):
        message = copy.deepcopy(instruct)
        message[0]["content"] = modal_token + "\n" + message[0]["content"]
    else:
        raise ValueError(f"Unsupported type of instruct: {type(instruct)}")

    if cfg.model_type in ("videollama2", "videollama2_mistral",
                          "videollama2_mixtral"):
        message = [{"role": "system", "content": MISTRAL_SYSTEM}] + message

    prompt = tokenizer.apply_chat_template(message, tokenize=False,
                                           add_generation_prompt=True)
    if modal == "av":
        return tokenizer_multimodal_tokens(
            prompt, tokenizer, (DEFAULT_VIDEO_TOKEN, DEFAULT_AUDIO_TOKEN))
    return tokenizer_multimodal_token(prompt, tokenizer, modal_token)


def _prep_audio(audio_input, cfg) -> np.ndarray:
    """A .wav or container path, a waveform [samples] or fbank features
    [T, 128] / [1, T, 128] -> [1, audio.max_frames, 128] BEATs features,
    zero-padded or trimmed (JAX `_prep_audio`)."""
    if isinstance(audio_input, str):
        feats = audio_lib.beats_preprocess(audio_lib.load_audio(audio_input))
    else:
        arr = np.asarray(audio_input, dtype=np.float32)
        if arr.ndim == 3:  # [1, T, 128] from the processor
            arr = arr[0]
        feats = audio_lib.beats_preprocess(arr) if arr.ndim == 1 else arr
    T = cfg.audio.max_frames
    if feats.shape[0] < T:
        feats = np.pad(feats, ((0, T - feats.shape[0]), (0, 0)))
    return feats[None, :T]


def _prep_av(video_path: str, cfg, num_frames: int) -> dict:
    """One video file -> {"video": [T, H, W, 3] uint8, "audio": [1, T_a,
    128]}: the AV model takes the clip's own audio track (reference
    README.md:130-132)."""
    return {"video": process_video(video_path, cfg=cfg.vision,
                                   aspect_ratio=None, num_frames=num_frames,
                                   out_dtype="uint8"),
            "audio": _prep_av_audio(video_path, cfg)}


def _prep_av_audio(video_path: str, cfg) -> np.ndarray:
    """The features of a container's own audio track. Where the decoder ran
    and found no audio track the request goes on with silence and a
    warning (the JAX package's posture); a decoder that cannot be built
    raises RuntimeError."""
    try:
        wav = audio_lib.load_audio(video_path)
    except OSError:
        warnings.warn(f"no decodable audio track in {video_path}; "
                      "AV request proceeds with silence", stacklevel=2)
        return np.zeros((1, cfg.audio.max_frames, 128), np.float32)
    return _prep_audio(wav, cfg)


def _inputs(media, cfg, modal: str):
    """(frames, audio) for Engine.generate from a request's media: None for
    "text"; "audio" takes what _prep_audio takes; "av" a container path
    (its frames and its own audio track, _prep_av) or a dict {"video":
    frames, "audio": ...}."""
    if modal == "text":
        return None, None
    if modal in ("audio", "av") and cfg.audio is None:
        raise ValueError(f"modal {modal!r} needs the audio-visual model "
                         "(cfg.audio is None)")
    if modal == "audio":
        return None, _prep_audio(media, cfg)
    if modal == "av":
        if isinstance(media, str):
            media = _prep_av(media, cfg, cfg.num_frames or NUM_FRAMES)
        return (_frames(media["video"], cfg, modal),
                _prep_audio(media["audio"], cfg))
    return _frames(media, cfg, modal), None


def _frames(image_or_video, cfg, modal: str) -> np.ndarray:
    """[1, T, ...] frames for the Engine: uint8 (RGB or I420) rides
    through, anything else becomes float32; an image is repeated to
    num_frames frames (videollama2_arch.py:119-120)."""
    arr = np.asarray(image_or_video)
    if arr.dtype != np.uint8:  # uint8 is normalized on the device
        arr = arr.astype(np.float32)
    if modal == "image":
        arr = np.broadcast_to(arr[:1], (cfg.num_frames,) + arr.shape[1:])
    return arr[None]


def _generation(kwargs, speculative_k: int = 0) -> GenerationConfig:
    do_sample = kwargs.get("do_sample", False)
    return GenerationConfig(
        do_sample=do_sample,
        temperature=kwargs.get("temperature", 0.2 if do_sample else 0.0),
        top_p=kwargs.get("top_p", 0.9),
        max_new_tokens=kwargs.get("max_new_tokens", 2048),
        seed=kwargs.get("seed", 0),
        speculative_k=speculative_k)


def mm_infer(image_or_video, instruct, model: VideoLLaMA2, tokenizer,
             modal: str = "video", **kwargs) -> str:
    """Single-sample multimodal inference (reference
    videollama2/__init__.py:32-114).

    image_or_video: [T, H, W, 3] numpy, float32 (normalized on the host)
    or uint8 (resized raw RGB, normalized on the device), or planar I420
    [T, H*3/2, W] uint8; None for modal "text"; for "audio", a .wav path,
    a 16 kHz waveform or fbank features; for "av", {"video": frames,
    "audio": one of those}.
    """
    cfg = model.config
    frames, audio = _inputs(image_or_video, cfg, modal)
    input_ids = build_prompt_ids(instruct, cfg, tokenizer, modal)
    outs = model.engine.generate(
        [input_ids], frames=frames, audio=audio,
        gen=_generation(kwargs, kwargs.get("speculative_k", 0)),
        eos_token_id=tokenizer.eos_token_id, image_mode=(modal == "image"),
        stream_cb=kwargs.get("stream_cb"))
    return tokenizer.decode(outs[0], skip_special_tokens=True).strip()


def mm_infer_batch(image_or_video, instructs, model: VideoLLaMA2, tokenizer,
                   modal: str = "video", **kwargs) -> list:
    """Batched variant of mm_infer: one media tensor, many prompts.

    The media is encoded ONCE and its tokens broadcast across the batch
    (Engine share_media), e.g. several questions about one video decode
    together at the cost of one encode. A `stream_cb(b, tokens)` keyword
    goes to Engine.generate, as in mm_infer.
    """
    if modal not in ("image", "video"):
        raise ValueError(f"Unsupported modal for batch: {modal}")
    cfg = model.config
    frames = _frames(image_or_video, cfg, modal)
    batch_ids = [build_prompt_ids(instruct, cfg, tokenizer, modal)
                 for instruct in instructs]
    outs = model.engine.generate(batch_ids, frames=frames,
                                 gen=_generation(kwargs),
                                 eos_token_id=tokenizer.eos_token_id,
                                 share_media=True, image_mode=False,
                                 stream_cb=kwargs.get("stream_cb"))
    return [tokenizer.decode(o, skip_special_tokens=True).strip()
            for o in outs]


class ChatSession:
    """Multi-turn chat with a prefix-cached KV (JAX `ChatSession`).

    Each turn renders the whole message history through the chat template
    and tokenizes it (build_prompt_ids). When the ids consumed so far are a
    strict prefix of the new render, only the new suffix feeds the engine
    (Engine.generate_continue): the media is encoded once and the history
    prefilled once for the whole conversation. A prefix mismatch or a full
    cache falls back to a fresh generate, so the replies are always those
    of per-turn mm_infer calls. `stats` counts both kinds of turn. Takes
    the modals and media mm_infer takes, prepared once here.
    """

    def __init__(self, image_or_video, model: VideoLLaMA2, tokenizer,
                 modal: str = "video", **gen_kwargs):
        self._inputs = _inputs(image_or_video, model.config, modal)
        self.model = model
        self.tokenizer = tokenizer
        self.modal = modal
        self.gen_kwargs = dict(gen_kwargs)
        self.messages: list = []
        self._session = None
        self.stats = {"cached_turns": 0, "fresh_turns": 0}

    def ask(self, text: str) -> str:
        cfg = self.model.config
        eng = self.model.engine
        gen = _generation(self.gen_kwargs,
                          self.gen_kwargs.get("speculative_k", 0))
        eos = self.tokenizer.eos_token_id
        self.messages.append({"role": "user", "content": text})
        full_ids = build_prompt_ids(copy.deepcopy(self.messages), cfg,
                                    self.tokenizer, self.modal)
        sess = self._session
        outs = None
        if sess is not None and _extends(full_ids, sess.token_history):
            try:
                outs, self._session = eng.generate_continue(
                    sess, full_ids[len(sess.token_history):], gen=gen,
                    eos_token_id=eos)
                self.stats["cached_turns"] += 1
            except ValueError:  # the cache is full
                outs = None
        if outs is None:
            frames, audio = self._inputs
            outs, self._session = eng.generate(
                [full_ids], frames=frames, audio=audio, gen=gen,
                eos_token_id=eos,
                image_mode=(self.modal == "image"), return_session=True)
            self.stats["fresh_turns"] += 1
        reply = self.tokenizer.decode(
            outs[0], skip_special_tokens=True).strip()
        self.messages.append({"role": "assistant", "content": reply})
        return reply


def _extends(full_ids, known) -> bool:
    """Whether full_ids strictly extends the ids a session consumed."""
    return len(full_ids) > len(known) and full_ids[:len(known)] == list(known)


class SessionStore:
    """Thread-safe LRU of engine Sessions keyed by a media digest and
    matched by token prefix (JAX `SessionStore`): a stateless server's way
    into prefix caching.

    `take` finds a stored session over the same media whose consumed ids
    are a strict prefix of the incoming render and removes it: its cache is
    written in place by generate_continue, so a session serves one request
    until the reply's session is `put` back. Each session holds a whole KV
    cache on the device, so the default cap is small.
    """

    def __init__(self, cap: int = 2):
        self.cap = cap
        self._entries: list = []          # [(digest, Session)]
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0}

    @staticmethod
    def media_digest(media) -> Optional[str]:
        """md5 of decoded media's bytes and shape, of a path's name (a .wav
        file), or, for an AV dict, its entries' digests joined by "+" in
        key order; None for text."""
        if media is None:
            return None
        if isinstance(media, dict):
            return "+".join(SessionStore.media_digest(media[k])
                            for k in sorted(media))
        if isinstance(media, str):
            return hashlib.md5(b"path:" + media.encode()).hexdigest()
        arr = np.ascontiguousarray(np.asarray(media))
        return hashlib.md5(
            arr.tobytes() + str(arr.shape).encode()).hexdigest()

    def take(self, digest, full_ids):
        with self._lock:
            for i, (d, sess) in enumerate(self._entries):
                if d == digest and _extends(full_ids, sess.token_history):
                    self._entries.pop(i)
                    self.stats["hits"] += 1
                    return sess
            self.stats["misses"] += 1
            return None

    def put(self, digest, session) -> None:
        with self._lock:
            self._entries.append((digest, session))
            while len(self._entries) > self.cap:
                self._entries.pop(0)


def mm_infer_session(image_or_video, instruct, model: VideoLLaMA2,
                     tokenizer, store: SessionStore, modal: str = "video",
                     **kwargs) -> str:
    """mm_infer with prefix caching through a SessionStore (JAX
    `mm_infer_session`): the reply is mm_infer's; when the rendered
    prompt extends a stored session's ids over the same media, only the
    new tokens feed the engine (Engine.generate_continue)."""
    cfg = model.config
    full_ids = build_prompt_ids(instruct, cfg, tokenizer, modal)
    digest = store.media_digest(None if modal == "text" else image_or_video)
    gen = _generation(kwargs, kwargs.get("speculative_k", 0))
    eos = tokenizer.eos_token_id
    stream_cb = kwargs.get("stream_cb")
    sess = store.take(digest, full_ids)
    outs = None
    if sess is not None:
        try:
            outs, sess = model.engine.generate_continue(
                sess, full_ids[len(sess.token_history):], gen=gen,
                eos_token_id=eos, stream_cb=stream_cb)
        except ValueError:  # the cache is full: a fresh generate
            outs = None
    if outs is None:
        frames, audio = _inputs(image_or_video, cfg, modal)
        outs, sess = model.engine.generate(
            [full_ids], frames=frames, audio=audio, gen=gen,
            eos_token_id=eos,
            image_mode=(modal == "image"), stream_cb=stream_cb,
            return_session=True)
    store.put(digest, sess)
    return tokenizer.decode(outs[0], skip_special_tokens=True).strip()
