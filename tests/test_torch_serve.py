"""The port's serving plane against the JAX package's, on the tiny
checkpoint of scripts/make_tiny_checkpoint.py (fp32, on the CPU) with its
offline tokenizer: the controller and a model worker on localhost (the
tests of tests/test_serve.py mirrored: registry, dispatch, streaming
through the proxy, heartbeats, the two-level hierarchy, status endpoints,
message-list prompts, base64 video, the wire formats, the session cache),
a streamed worker answer equal to the JAX worker's over the same
checkpoint, a worker without the decoder answering a container request
with error_code 1, the dynamic batcher (tests/test_dynamic_batching.py
mirrored, plus grouped media encoded once a distinct video and answers
equal to B = 1), the Engine's `media_group` against the JAX Engine's, the
OpenAI-compatible and web servers (tests/test_web_server.py mirrored), the
CLI and the tokenizer factory, and the launch counter under threads."""

import base64
import builtins
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from argparse import Namespace
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import videollama2_tpu
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.serve import model_worker as jworker_mod
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.constants import (VIDEO_TOKEN_INDEX,
                                             WORKER_HEART_BEAT_INTERVAL)
from videollama2_tpu_torch.core import config as cfglib
from videollama2_tpu_torch.inference import api as tapi
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.media import _native
from videollama2_tpu_torch.media import video_reader as tvr
from videollama2_tpu_torch.ops import _build
from videollama2_tpu_torch.serve import cli as cli_mod
from videollama2_tpu_torch.serve import controller as ctrl_mod
from videollama2_tpu_torch.serve import model_worker as worker_mod
from videollama2_tpu_torch.serve import openai_api as oai
from videollama2_tpu_torch.serve import register_worker as register_mod
from videollama2_tpu_torch.serve import test_message as message_mod
from videollama2_tpu_torch.serve import web_server as web_mod
from videollama2_tpu_torch.serve.batching import DynamicBatcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from avi_writer import write_avi  # noqa: E402
from png_writer import encode_png  # noqa: E402

ENGINE_KW = dict(max_len=256, buckets=(64, 192))


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _chunks(raw: bytes):
    return [json.loads(c) for c in raw.split(b"\0") if c]


def _serve(handler):
    srv = ThreadingHTTPServer(("localhost", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def load_tiny_tokenizer(model_path):
    """A tokenizer factory (--tokenizer test_torch_serve:load_tiny_tokenizer)."""
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(model_path, use_fast=True)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from make_tiny_checkpoint import build_checkpoint
    return build_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def loaded(ckpt):
    return tapi.model_init(ckpt, dtype=torch.float32,
                           tokenizer=load_tiny_tokenizer(ckpt),
                           device="cpu", **ENGINE_KW)


@pytest.fixture(scope="module")
def media(tmp_path_factory, loaded):
    """An AVI at 64x48 (12 frames and 2 s of audio), one without audio, and
    a PNG at the tower's size."""
    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (12, 48, 64, 3), dtype=np.uint8)
    avi, silent = str(d / "clip.avi"), str(d / "silent.avi")
    write_avi(avi, frames, rng.uniform(-0.5, 0.5, 32000), fps=5)
    write_avi(silent, frames, None, fps=5)
    S = loaded[0].config.vision.image_size
    png = encode_png(rng.integers(0, 256, (S, S, 3), dtype=np.uint8))
    return {"avi": avi, "silent": silent, "png": png}


@pytest.fixture(scope="module")
def serve_stack(loaded):
    controller = ctrl_mod.Controller("shortest_queue")
    ctrl_srv, ctrl_port = _serve(ctrl_mod.make_handler(controller))
    worker = worker_mod.ModelWorker(
        f"http://localhost:{ctrl_port}", "", "tiny", model_name="tiny",
        limit_concurrency=2, register=False, session_cache=0,
        preloaded=loaded)
    wrk_srv, wrk_port = _serve(worker_mod.make_handler(worker))
    worker.worker_addr = f"http://localhost:{wrk_port}"
    worker.register_to_controller()
    # heartbeats, as a worker that registers itself sends them: without
    # them the controller drops the worker 30-60 s after this, which a
    # loaded host can take to reach the later tests
    stop = threading.Event()

    def beat():
        while not stop.wait(WORKER_HEART_BEAT_INTERVAL):
            worker.send_heart_beat()
    threading.Thread(target=beat, daemon=True).start()
    yield controller, worker, ctrl_port, wrk_port
    stop.set()
    ctrl_srv.shutdown()
    wrk_srv.shutdown()


@pytest.fixture()
def no_decoder(tmp_path, monkeypatch):
    """A host on which video_decoder.cc does not build (tests/
    test_torch_media.py has the same fixture)."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'video_decoder.cc:20:10: fatal error: "
                   "libavcodec/avcodec.h: No such file or directory' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(tvr, "_lib", None)


# -- controller and worker (tests/test_serve.py) ------------------------------

def test_register_and_list(serve_stack):
    _, _, ctrl_port, _ = serve_stack
    with _post(f"http://localhost:{ctrl_port}/list_models", {}) as r:
        assert "tiny" in json.loads(r.read())["models"]


def test_dispatch_and_stream(serve_stack):
    _, _, ctrl_port, _ = serve_stack
    with _post(f"http://localhost:{ctrl_port}/get_worker_address",
               {"model": "tiny"}) as r:
        assert json.loads(r.read())["address"].startswith(
            "http://localhost:")
    with _post(f"http://localhost:{ctrl_port}/worker_generate_stream",
               {"model": "tiny", "prompt": "what is the cat doing ?",
                "temperature": 0.0, "max_new_tokens": 6}) as r:
        chunks = _chunks(r.read())
    assert chunks and chunks[-1]["error_code"] == 0
    assert isinstance(chunks[-1]["text"], str)
    # an unknown model: error_code 2 from the controller
    with _post(f"http://localhost:{ctrl_port}/worker_generate_stream",
               {"model": "nope", "prompt": "hi"}) as r:
        assert _chunks(r.read()) == [{"text": "", "error_code": 2}]


def test_heartbeat_updates_queue(serve_stack):
    controller, worker, _, _ = serve_stack
    assert controller.receive_heart_beat(worker.worker_addr, 3)
    assert controller.worker_info[worker.worker_addr].queue_length == 3
    assert not controller.receive_heart_beat("http://nonexistent:1", 0)
    worker.send_heart_beat()
    assert controller.worker_info[worker.worker_addr].queue_length == 0


def test_controller_hierarchy_two_level(serve_stack):
    """A parent controller sees a child controller as one worker and
    proxies a stream through parent -> child -> worker."""
    child, _, child_port, _ = serve_stack
    parent = ctrl_mod.Controller("lottery")
    parent_srv, parent_port = _serve(ctrl_mod.make_handler(parent))
    try:
        assert child.register_to_parent(f"http://localhost:{child_port}",
                                        f"http://localhost:{parent_port}")
        with _post(f"http://localhost:{parent_port}/list_models", {}) as r:
            assert "tiny" in json.loads(r.read())["models"]
        with _post(f"http://localhost:{parent_port}/get_worker_address",
                   {"model": "tiny"}) as r:
            assert json.loads(r.read())["address"] == \
                f"http://localhost:{child_port}"
        with _post(f"http://localhost:{parent_port}/worker_generate_stream",
                   {"model": "tiny", "prompt": "what is the cat doing ?",
                    "temperature": 0.0, "max_new_tokens": 4}) as r:
            chunks = _chunks(r.read())
        assert chunks and chunks[-1]["error_code"] == 0
        assert parent.receive_heart_beat(
            f"http://localhost:{child_port}",
            child.aggregate_status()["queue_length"])
    finally:
        parent_srv.shutdown()


def test_worker_status_endpoints(serve_stack, loaded):
    _, _, _, wrk_port = serve_stack
    with _post(f"http://localhost:{wrk_port}/worker_get_status", {}) as r:
        assert json.loads(r.read())["model_names"] == ["tiny"]
    with _post(f"http://localhost:{wrk_port}/model_details", {}) as r:
        assert json.loads(r.read())["context_length"] == \
            loaded[0].config.llm.max_position_embeddings
    with _post(f"http://localhost:{wrk_port}/count_token",
               {"prompt": "the cat"}) as r:
        assert json.loads(r.read())["count"] >= 1
    with _post(f"http://localhost:{wrk_port}/count_token",
               {"prompt": [{"role": "user", "content": "the cat"},
                           {"role": "assistant", "content": "sits"}]}) as r:
        assert json.loads(r.read())["count"] >= 2
    with pytest.raises(urllib.error.HTTPError):
        _post(f"http://localhost:{wrk_port}/nope", {})


def test_worker_multiturn_message_list(serve_stack):
    _, _, _, wrk_port = serve_stack
    msgs = [{"role": "user", "content": "what is the cat doing ?"},
            {"role": "assistant", "content": "the cat sits."},
            {"role": "user", "content": "and the dog ?"}]
    with _post(f"http://localhost:{wrk_port}/worker_generate_stream",
               {"prompt": msgs, "temperature": 0.0,
                "max_new_tokens": 4}) as r:
        chunks = _chunks(r.read())
    assert chunks and chunks[-1]["error_code"] == 0


def test_worker_base64_video(serve_stack, media):
    """Clients without a shared filesystem send the video base64-embedded
    (`videos`); the worker spools it to a temporary file and decodes it."""
    _, _, _, wrk_port = serve_stack
    with open(media["avi"], "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    with _post(f"http://localhost:{wrk_port}/worker_generate_stream",
               {"prompt": "describe the video", "videos": [b64],
                "video_name": "clip.avi", "temperature": 0.0,
                "max_new_tokens": 4}) as r:
        chunks = _chunks(r.read())
    assert chunks and chunks[-1]["error_code"] == 0
    assert chunks[-1]["text"]


def test_worker_wire_formats(serve_stack, media):
    """_decode_media follows the wire: i420 ships [T, H*3/2, W] uint8 (the
    C++ YUV route for a container), rgb uint8 [T, H, W, 3], fp32
    normalized floats; a base64 image likewise."""
    _, worker, _, _ = serve_stack
    cfg = worker.model.config
    H, T = cfg.vision.image_size, cfg.num_frames
    image = base64.b64encode(media["png"]).decode()
    old = worker.wire
    try:
        worker.wire = "i420"
        t, modal = worker._decode_media({"video": media["avi"]})
        assert modal == "video" and t.dtype == np.uint8
        assert t.shape == (T, H * 3 // 2, H)
        t, modal = worker._decode_media({"images": [image]})
        assert modal == "image" and t.shape == (1, H * 3 // 2, H)
        worker.wire = "rgb"
        t, _ = worker._decode_media({"video": media["avi"]})
        assert t.dtype == np.uint8 and t.shape == (T, H, H, 3)
        worker.wire = "fp32"
        t, _ = worker._decode_media({"video": media["avi"]})
        assert t.dtype == np.float32 and t.shape == (T, H, H, 3)
        t, modal = worker._decode_media({})
        assert t is None and modal == "text"
    finally:
        worker.wire = old


def test_web_server_messages_helper():
    msgs = web_mod.WebBackend._messages(
        {"prompt": "and now ?",
         "history": [["hi", "hello"], ["more", "sure"]]})
    assert msgs == [{"role": "user", "content": "hi"},
                    {"role": "assistant", "content": "hello"},
                    {"role": "user", "content": "more"},
                    {"role": "assistant", "content": "sure"},
                    {"role": "user", "content": "and now ?"}]


def test_worker_session_cache_multiturn(serve_stack):
    """Prefix-cached worker turns: the stateless replies, a store hit, and
    incremental stream chunks."""
    _, worker, ctrl_port, _ = serve_stack

    def turn(prompt):
        with _post(f"http://localhost:{ctrl_port}/worker_generate_stream",
                   {"model": "tiny", "prompt": prompt, "temperature": 0.0,
                    "max_new_tokens": 8}) as r:
            chunks = _chunks(r.read())
        assert chunks[-1]["error_code"] == 0
        return chunks

    msgs = [{"role": "user", "content": "what is in the video ?"}]
    assert worker.session_store is None
    ref1 = turn(list(msgs))[-1]["text"]
    msgs2 = msgs + [{"role": "assistant", "content": ref1},
                    {"role": "user", "content": "and then what ?"}]
    ref2 = turn(list(msgs2))[-1]["text"]
    worker.session_store = tapi.SessionStore(cap=2)
    try:
        chunks1 = turn(list(msgs))
        assert chunks1[-1]["text"] == ref1
        assert len(chunks1) >= 2, "no incremental stream chunks"
        assert turn(list(msgs2))[-1]["text"] == ref2
        assert worker.session_store.stats["hits"] >= 1
    finally:
        worker.session_store = None


@pytest.fixture(scope="module")
def jax_worker(ckpt):
    """The JAX package's worker over the same checkpoint (built as its own
    tests build it)."""
    worker = jworker_mod.ModelWorker.__new__(jworker_mod.ModelWorker)
    worker.model_name = "tiny"
    worker.model, worker.processor, worker.tokenizer = \
        videollama2_tpu.model_init(ckpt, dtype=jnp.float32,
                                   attn_impl="xla", **ENGINE_KW)
    worker.semaphore = threading.Semaphore(2)
    worker.limit_concurrency = 2
    worker.batcher = None
    worker._queue = 0
    worker._qlock = threading.Lock()
    return worker


@pytest.mark.parametrize("kind", ["text", "video i420", "video rgb",
                                  "image"])
def test_worker_stream_matches_jax(serve_stack, jax_worker, media, kind):
    """A streamed answer of the port's worker equals the JAX worker's, on
    the weights both load from one checkpoint: text; an AVI on the i420
    wire (both packages scale and crop it in the same C++ code) and on the
    rgb wire; a base64 PNG at the tower's size (no resize in either)."""
    _, worker, _, _ = serve_stack
    wire = "rgb" if kind == "video rgb" else "i420"
    params = {"prompt": "describe the video briefly", "temperature": 0.0,
              "max_new_tokens": 8}
    if kind.startswith("video"):
        params["video"] = media["avi"]
    elif kind == "image":
        params["images"] = [base64.b64encode(media["png"]).decode()]
    old = worker.wire
    worker.wire = jax_worker.wire = wire
    try:
        got = [json.loads(c) for c in b"".join(
            worker.generate_stream(params)).split(b"\0") if c]
        want = [json.loads(c) for c in b"".join(
            jax_worker.generate_stream(params)).split(b"\0") if c]
    finally:
        worker.wire = old
    assert got[-1] == want[-1] and got[-1]["error_code"] == 0
    assert got[-1]["text"]
    if kind == "video rgb":
        return   # the RGB resize is torch's here, PIL's there (1 level)
    assert got == want


def test_worker_without_decoder_answers_error_code_1(serve_stack, media,
                                                     no_decoder):
    """On a host where the decoder cannot be built, a container request is
    answered with one error_code 1 chunk naming libavcodec, through the
    controller's proxy and without hanging; the worker goes on serving."""
    _, _, ctrl_port, _ = serve_stack
    with _post(f"http://localhost:{ctrl_port}/worker_generate_stream",
               {"model": "tiny", "prompt": "describe the video",
                "video": media["avi"], "max_new_tokens": 4},
               timeout=30) as r:
        chunks = _chunks(r.read())
    assert len(chunks) == 1 and chunks[0]["error_code"] == 1
    assert "libavcodec" in chunks[0]["text"]
    with _post(f"http://localhost:{ctrl_port}/worker_generate_stream",
               {"model": "tiny", "prompt": "hi", "max_new_tokens": 2},
               timeout=30) as r:
        assert _chunks(r.read())[-1]["error_code"] == 0


@pytest.mark.parametrize("params,word", [
    ({"images": [base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(32)).decode()]},
     "JPEG"),
    ({"video": "missing.mp4"}, "cannot open video"),
    ({"video": "clip.gif"}, "GIF"),
])
def test_worker_undecodable_media_error_code_1(serve_stack, params, word):
    _, worker, _, _ = serve_stack
    chunks = _chunks(b"".join(worker.generate_stream(
        dict(params, prompt="what is it ?"))))
    assert len(chunks) == 1 and chunks[0]["error_code"] == 1
    assert word in chunks[0]["text"]


def test_worker_safety_gate(serve_stack, monkeypatch):
    _, worker, _, _ = serve_stack
    monkeypatch.setattr(worker_mod, "BANNED_WORDS", ["forbidden"])
    chunks = _chunks(b"".join(worker.generate_stream(
        {"prompt": "a forbidden question"})))
    assert chunks == [{"text": "input violates safety policy.",
                       "error_code": 1}]


def test_message_and_register_clients(serve_stack, capsys, monkeypatch):
    """serve/test_message.py streams one prompt through the controller;
    serve/register_worker.py registers a worker by its address."""
    controller, worker, ctrl_port, _ = serve_stack
    monkeypatch.setattr(sys, "argv", [
        "test_message", "--controller-address",
        f"http://localhost:{ctrl_port}", "--model-name", "tiny",
        "--max-new-tokens", "3", "--message", "what is the cat doing ?"])
    message_mod.main()
    assert "ASSISTANT:" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "register_worker", "--controller-address",
        f"http://localhost:{ctrl_port}", "--worker-name",
        worker.worker_addr])
    register_mod.main()
    assert controller.worker_info[worker.worker_addr].model_names == ["tiny"]


# -- the dynamic batcher (tests/test_dynamic_batching.py) ---------------------

class _Recorder:
    """The Engine, with each generate call's batch and media recorded."""

    def __init__(self, engine):
        self._engine = engine
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def generate(self, ids, frames=None, **kw):
        self.calls.append({"B": len(ids), "media": None if frames is None
                           else frames.shape[0],
                           "media_group": kw.get("media_group"),
                           "image_mode": kw.get("image_mode")})
        return self._engine.generate(ids, frames=frames, **kw)


def test_worker_reads_the_checkpoint_tokenizer(ckpt, loaded, jax_worker,
                                              media):
    """A worker given no tokenizer reads the checkpoint's own files
    (multimodal/hf_tokenizer.py) in model_init; with the module's fp32
    model in place of the one it loaded, its streamed chunks (decoded
    through the reader) equal the JAX worker's, and a batcher over the
    reader streams what one over AutoTokenizer does."""
    from videollama2_tpu_torch.multimodal import hf_tokenizer
    worker = worker_mod.ModelWorker("http://localhost:1", "", ckpt,
                                    model_name="tiny", register=False,
                                    session_cache=0, device="cpu")
    assert isinstance(worker.tokenizer, hf_tokenizer.HFTokenizer)
    worker.model, worker.processor = loaded[0], loaded[1]
    for extra in ({}, {"video": media["avi"]}):
        params = {"prompt": "describe the video briefly",
                  "temperature": 0.0, "max_new_tokens": 8, **extra}
        got = [json.loads(c) for c in b"".join(
            worker.generate_stream(params)).split(b"\0") if c]
        want = [json.loads(c) for c in b"".join(
            jax_worker.generate_stream(params)).split(b"\0") if c]
        assert got == want and got[-1]["error_code"] == 0
    streams = []
    for tok in (worker.tokenizer, loaded[2]):
        batcher = DynamicBatcher(loaded[0], tok, max_batch=2, window_ms=10)
        try:
            streams.append(_drain(batcher.submit(
                "tell me a story", "text", None, max_new_tokens=8)))
        finally:
            batcher.close()
    assert streams[0] == streams[1] and streams[0][-1][0] == "done"


@pytest.fixture(scope="module")
def batch_stack(loaded):
    model, _, tok = loaded
    recorded = tapi.VideoLLaMA2(config=model.config,
                                engine=_Recorder(model.engine))
    return recorded, tok, DynamicBatcher(recorded, tok, max_batch=4,
                                         window_ms=300)


def _drain(q):
    chunks = []
    while True:
        kind, text = q.get(timeout=600)
        chunks.append((kind, text))
        if kind in ("done", "error"):
            return chunks


def _concurrently(*fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
        assert not t.is_alive()
    return out


def test_concurrent_text_requests_share_a_batch(batch_stack):
    _, _, batcher = batch_stack
    b0 = batcher.stats["batches"]
    qs = [batcher.submit(f"count to {i} ?", "text", None, max_new_tokens=4)
          for i in range(3)]
    for chunks in map(_drain, qs):
        assert chunks[-1][0] == "done" and isinstance(chunks[-1][1], str)
    assert batcher.stats["batches"] == b0 + 1
    assert batcher.stats["max_group"] >= 3


def _video(cfg, seed):
    H = cfg.vision.image_size
    return np.random.default_rng(seed).integers(
        0, 256, (cfg.num_frames, H, H, 3), dtype=np.uint8)


def test_grouped_media_encoded_once_and_equal_to_b1(batch_stack):
    """Two questions about one video, one about another and a text request
    ride one engine call (padded to 4 rows) that encodes the 2 distinct
    videos once each; every answer equals its own B = 1 mm_infer."""
    model, tok, batcher = batch_stack
    cfg = model.config
    va, vb = _video(cfg, 0), _video(cfg, 1)
    requests = [("what is shown ?", "video", va),
                ("why is it moving ?", "video", va.copy()),
                ("describe the scene", "video", vb),
                ("hello there", "text", None)]
    model.engine.calls.clear()
    queues = [batcher.submit(i, m, t, max_new_tokens=6)
              for i, m, t in requests]
    results = [_drain(q) for q in queues]
    assert model.engine.calls == [{"B": 4, "media": 2,
                                   "media_group": [0, 0, 1, 0],
                                   "image_mode": False}]
    for (instruct, modal, tensor), chunks in zip(requests, results):
        assert chunks[-1][0] == "done"
        assert chunks[-1][1] == tapi.mm_infer(tensor, instruct, model, tok,
                                              modal=modal, max_new_tokens=6)


def test_image_requests_batch_in_image_mode(batch_stack, media):
    """Images batch on their own, in the engine's image mode (one frame a
    row; the I420 wire's [1, H*3/2, W] as well), with the B = 1 answers."""
    model, tok, batcher = batch_stack
    from videollama2_tpu_torch.media.preprocess import process_image
    from videollama2_tpu_torch.media import wire
    cfg = model.config
    rgb = process_image(media["png"], cfg.vision, aspect_ratio=None,
                        out_dtype="uint8")
    for tensor in (rgb, wire.rgb_to_i420(rgb)):
        model.engine.calls.clear()
        results = [_drain(q) for q in [
            batcher.submit(q, "image", tensor, max_new_tokens=5)
            for q in ("what is shown ?", "describe the image")]]
        assert [c["image_mode"] for c in model.engine.calls] == [True]
        for q, chunks in zip(("what is shown ?", "describe the image"),
                             results):
            assert chunks[-1] == ("done", tapi.mm_infer(
                tensor, q, model, tok, modal="image", max_new_tokens=5))


def test_streaming_chunks_arrive_before_done(batch_stack):
    _, _, batcher = batch_stack
    kinds = [k for k, _ in _drain(batcher.submit(
        "tell me a story", "text", None, max_new_tokens=8))]
    assert kinds[-1] == "done" and "chunk" in kinds[:-1]


def test_per_request_max_new_tokens_cap(batch_stack):
    _, tok, batcher = batch_stack
    qa = batcher.submit("a ?", "text", None, max_new_tokens=2)
    qb = batcher.submit("b ?", "text", None, max_new_tokens=10)
    ra, rb = _drain(qa), _drain(qb)
    assert ra[-1][0] == "done" and rb[-1][0] == "done"
    assert len(tok(ra[-1][1]).input_ids) <= 4


def test_submit_ignores_unsupported_gen_kwargs(batch_stack):
    _, _, batcher = batch_stack
    chunks = _drain(batcher.submit("hello there", "text", None,
                                   max_new_tokens=4, speculative_k=8))
    assert chunks[-1][0] == "done"


def test_batcher_close(loaded):
    """close() stops the collectors after their groups: queued and later
    requests get an error, and the threads (holding the Engine) end."""
    model, _, tok = loaded
    batcher = DynamicBatcher(model, tok, max_batch=4, window_ms=50)
    assert _drain(batcher.submit("hello", "text", None,
                                 max_new_tokens=2))[-1][0] == "done"
    batcher.close()
    assert not any(t.is_alive() for t in batcher._threads)
    assert _drain(batcher.submit("hello", "text", None)) == [
        ("error", "the batcher is closed")]


def test_batched_worker_streams(loaded, media):
    """A worker with dynamic_batch=True answers concurrent requests through
    its batcher, per-request streams ending in error_code 0."""
    worker = worker_mod.ModelWorker("", "", "tiny", register=False,
                                    dynamic_batch=True, preloaded=loaded)
    assert worker.batcher is not None and worker.session_store is None
    params = [{"prompt": "describe the video", "video": media["avi"],
               "max_new_tokens": 4},
              {"prompt": "hello", "max_new_tokens": 4}]
    outs = _concurrently(*(
        (lambda p=p: _chunks(b"".join(worker.generate_stream(p))))
        for p in params))
    for chunks in outs:
        assert chunks[-1]["error_code"] == 0 and chunks[-1]["text"]
    assert worker.batcher.stats["requests"] == 2


# -- the Engine's media_group -------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model(projector_type="stc_connector")
    from videollama2_tpu.core import config as jcfglib
    jcfg = jcfglib.tiny_model(projector_type="stc_connector")
    jparams = jvl2.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg)


@pytest.mark.parametrize("wire_fmt", ["rgb", "i420"])
def test_media_group_matches_jax(tiny, wire_fmt):
    """G = 2 distinct videos for 4 prompts (one text-only, pointing at
    group 0 with no visual slot): the JAX Engine's tokens, and those of
    the plain vision mode over the gathered videos."""
    from videollama2_tpu_torch.media import wire
    cfg, jp, tp = tiny
    H, T = cfg.vision.image_size, cfg.num_frames
    rgb = np.random.default_rng(4).integers(0, 256, (2, T, H, H, 3),
                                            dtype=np.uint8)
    frames = wire.rgb_to_i420(rgb) if wire_fmt == "i420" else rgb
    prompts = [[1, 5, 9, VIDEO_TOKEN_INDEX, 17, 4],
               [1, 33, VIDEO_TOKEN_INDEX, 8, 2, 6, 200, 7],
               [1, 12, 13, 14],
               [1, VIDEO_TOKEN_INDEX, 3]]
    group = [1, 0, 0, 1]
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, max_len=128, buckets=(64,))
    want = jeng.generate(prompts, frames=frames, media_group=group,
                         gen=JaxGenerationConfig(max_new_tokens=6),
                         eos_token_id=-1)
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    got = eng.generate(prompts, frames=frames, media_group=group,
                       gen=GenerationConfig(max_new_tokens=6),
                       eos_token_id=-1)
    assert got == want
    gathered = frames[[1, 0, 0, 1]]
    assert eng.generate(prompts, frames=gathered,
                        gen=GenerationConfig(max_new_tokens=6),
                        eos_token_id=-1) == got
    with pytest.raises(ValueError, match="media_group"):
        eng.generate(prompts, frames=frames, media_group=[0, 1])


def test_engine_runs_one_generate_at_a_time(tiny, monkeypatch):
    """Generates from 4 host threads at once queue on the Engine's lock:
    never two prefills or decode steps in flight, and each thread gets its
    serial tokens."""
    from videollama2_tpu_torch.models import llm as tllm
    cfg, _, tp = tiny
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=128, buckets=(64,),
                 device="cpu")
    H, T = cfg.vision.image_size, cfg.num_frames
    frames = np.random.default_rng(5).integers(0, 256, (4, 1, T, H, H, 3),
                                               dtype=np.uint8)
    prompt = [[1, 5, VIDEO_TOKEN_INDEX, 17]]
    gen = GenerationConfig(max_new_tokens=4)
    serial = [eng.generate(prompt, frames=f, gen=gen, eos_token_id=-1)
              for f in frames]
    inside, most = [0], [0]
    lock = threading.Lock()
    for name in ("prefill", "decode_step"):
        orig = getattr(tllm, name)

        def counted(*a, _orig=orig, **k):
            with lock:
                inside[0] += 1
                most[0] = max(most[0], inside[0])
            try:
                return _orig(*a, **k)
            finally:
                with lock:
                    inside[0] -= 1
        monkeypatch.setattr(tllm, name, counted)
    got = _concurrently(*(
        (lambda f=f: eng.generate(prompt, frames=f, gen=gen,
                                  eos_token_id=-1)) for f in frames))
    assert got == serial and most[0] == 1


# -- the OpenAI-compatible server -------------------------------------------

@pytest.fixture(scope="module")
def oai_stack(loaded, batch_stack):
    backend = oai.OpenAIBackend("tiny", "tiny", preloaded=loaded)
    srv, port = _serve(oai.make_handler(backend))
    yield backend, port
    srv.shutdown()


def _complete(port, body, timeout=600):
    with _post(f"http://localhost:{port}/v1/chat/completions", body,
               timeout=timeout) as r:
        return r.read()


def test_openai_image_data_url_and_video_path(oai_stack, media, loaded):
    """A chat completion with a data-URL PNG (the port's still reader) and
    one with a video path give mm_infer's answers on the processors'
    output."""
    backend, port = oai_stack
    model, processor, tok = loaded
    url = "data:image/png;base64," + base64.b64encode(media["png"]).decode()
    for part, modal, tensor in (
            ({"type": "image_url", "image_url": {"url": url}}, "image",
             processor["image"](media["png"])),
            ({"type": "video_url", "video_url": {"url": media["avi"]}},
             "video", processor["video"](media["avi"]))):
        body = {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "what is shown ?"}, part]}],
            "max_tokens": 5}
        reply = json.loads(_complete(port, body))
        msg = reply["choices"][0]["message"]
        assert msg == {"role": "assistant", "content": tapi.mm_infer(
            tensor, "what is shown ?", model, tok, modal=modal,
            max_new_tokens=5)}


IMAGE_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_images")


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(IMAGE_FIXTURES) if n != "golden.json"))
def test_image_formats_match_jax_in_worker_and_openai(
        serve_stack, jax_worker, oai_stack, name):
    """Progressive, CMYK and RGB-coded JPEG, Adam7 and 16-bit PNG and a
    GIF still (tests/fixtures/torch_images/), sent base64 to the worker
    and as an OpenAI data URL, give the JAX package's tensors: the
    worker's on the i420 and rgb wires, the OpenAI server's against JAX's
    processor on PIL's image (what JAX's server hands it)."""
    import io
    from PIL import Image
    with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
        raw = f.read()
    _, worker, _, _ = serve_stack
    params = {"images": [base64.b64encode(raw).decode()]}
    old = worker.wire
    try:
        for wire in ("i420", "rgb"):
            worker.wire = jax_worker.wire = wire
            got, got_modal = worker._decode_media(params)
            want, want_modal = jax_worker._decode_media(params)
            assert got_modal == want_modal == "image"
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    finally:
        worker.wire = old
    backend, _ = oai_stack
    url = "data:image/x;base64," + base64.b64encode(raw).decode()
    got = np.asarray(backend._media(url, "image"))
    want = np.asarray(jax_worker.processor["image"](Image.open(
        io.BytesIO(raw))))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_openai_streaming_models_and_errors(oai_stack, media):
    backend, port = oai_stack
    raw = _complete(port, {"messages": [{"role": "user", "content": "hi"}],
                           "max_tokens": 3, "stream": True})
    events = [ln for ln in raw.split(b"\n\n") if ln]
    assert events[-1] == b"data: [DONE]"
    assert json.loads(events[1][6:])["choices"][0]["finish_reason"] == "stop"
    with urllib.request.urlopen(f"http://localhost:{port}/v1/models",
                                timeout=30) as r:
        assert json.loads(r.read())["data"][0]["id"] == "tiny"
    gif = "data:image/gif;base64," + base64.b64encode(b"GIF89a" + bytes(
        16)).decode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _complete(port, {"messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": gif}}]}]})
    assert e.value.code == 500 and b"GIF" in e.value.read()


def test_openai_server_dynamic_batch(batch_stack):
    """Two concurrent completions share one batched engine call."""
    model, tok, batcher = batch_stack
    backend = oai.OpenAIBackend.__new__(oai.OpenAIBackend)
    backend.model_name = "tiny"
    backend.model, backend.tokenizer = model, tok
    backend.processor = None
    backend.batcher = batcher
    srv, port = _serve(oai.make_handler(backend))
    try:
        b0 = batcher.stats["batches"]
        outs = _concurrently(*(
            (lambda t=t: json.loads(_complete(port, {"messages": [
                {"role": "user", "content": f"say {t} ?"}],
                "max_tokens": 4})))
            for t in ("a", "b")))
    finally:
        srv.shutdown()
    for out in outs:
        assert out["choices"][0]["message"]["role"] == "assistant"
    assert batcher.stats["batches"] == b0 + 1


# -- the web server (tests/test_web_server.py) --------------------------------

@pytest.fixture()
def web_stack(serve_stack, tmp_path, monkeypatch):
    _, _, ctrl_port, _ = serve_stack
    logdir = tmp_path / "weblogs"
    monkeypatch.setattr(web_mod, "LOGDIR", str(logdir))
    backend = web_mod.WebBackend(Namespace(
        model_path=None, model_name="tiny",
        controller_address=f"http://localhost:{ctrl_port}"))
    srv, port = _serve(web_mod.make_handler(backend))
    yield port, logdir
    srv.shutdown()


def test_page_serves(web_stack):
    port, _ = web_stack
    with urllib.request.urlopen(f"http://localhost:{port}/",
                                timeout=30) as r:
        body = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/html")
    for needle in ("/generate", "/vote", "regenerate()", "clearChat()"):
        assert needle in body


def test_generate_proxies_stream_with_history(web_stack):
    port, logdir = web_stack
    with _post(f"http://localhost:{port}/generate",
               {"prompt": "and the dog ?",
                "history": [["what is the cat doing ?", "the cat sits."]]},
               timeout=600) as r:
        chunks = _chunks(r.read())
    assert chunks and chunks[-1]["error_code"] == 0
    recs = [json.loads(ln) for f in logdir.glob("web-conv-*.json")
            for ln in f.read_text().splitlines()]
    assert any(rec["type"] == "chat" and rec["prompt"] == "and the dog ?"
               for rec in recs)


def test_generate_routes_base64_media(web_stack, media):
    port, logdir = web_stack
    with open(media["avi"], "rb") as f:
        avi = base64.b64encode(f.read()).decode()
    png = base64.b64encode(media["png"]).decode()
    for b64, name in ((avi, "clip.avi"), (png, "frame.png")):
        with _post(f"http://localhost:{port}/generate",
                   {"prompt": "describe it", "media_b64": b64,
                    "media_name": name}, timeout=600) as r:
            chunks = _chunks(r.read())
        assert chunks and chunks[-1]["error_code"] == 0
    log = "".join(f.read_text() for f in logdir.glob("web-conv-*.json"))
    assert "media_b64" not in log and "clip.avi" in log


def test_vote_logged(web_stack):
    port, logdir = web_stack
    with _post(f"http://localhost:{port}/vote",
               {"vote": 1, "history": [["hi", "hello"]]}) as r:
        assert json.loads(r.read()) == {}
    recs = [json.loads(ln) for f in logdir.glob("web-conv-*.json")
            for ln in f.read_text().splitlines()]
    assert [r for r in recs if r["type"] == "vote"][-1]["vote"] == 1


def test_unknown_path_404(web_stack):
    port, _ = web_stack
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"http://localhost:{port}/nope", {})
    assert e.value.code == 404


def test_web_server_adhoc_mode(ckpt, media, tmp_path, monkeypatch):
    """--model-path with a tokenizer factory serves in-process; an upload
    is spooled to a temporary file and removed."""
    monkeypatch.setattr(web_mod, "LOGDIR", str(tmp_path))
    backend = web_mod.WebBackend(Namespace(
        model_path=ckpt, model_name=None, device="cpu", wire="rgb",
        tokenizer="test_torch_serve:load_tiny_tokenizer"))
    chunks = _chunks(b"".join(backend.generate({
        "prompt": "describe it", "media_name": "frame.png",
        "media_b64": base64.b64encode(media["png"]).decode()})))
    assert chunks[-1]["error_code"] == 0 and chunks[-1]["text"]


# -- the CLI and the tokenizer factory ---------------------------------------

def test_cli_chat_loop(ckpt, media, monkeypatch, capsys):
    turns = iter(["what is shown ?", "and then ?", "exit"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(turns))
    monkeypatch.setattr(sys, "argv", [
        "cli", "--model-path", ckpt, "--device", "cpu",
        "--tokenizer", "test_torch_serve:load_tiny_tokenizer",
        "--video-file", media["avi"], "--max-new-tokens", "4"])
    cli_mod.main()
    out = capsys.readouterr().out
    assert out.count("ASSISTANT:") == 2


def test_load_tokenizer(ckpt):
    tok = tapi.load_tokenizer("test_torch_serve:load_tiny_tokenizer", ckpt)
    assert tok("the cat").input_ids
    # no factory: the directory's own files, read as the factory reads them
    own = tapi.load_tokenizer(None, ckpt)
    assert type(own).__name__ == "HFTokenizer"
    assert own("the cat").input_ids == tok("the cat").input_ids
    for spec, match in (("nomodule", "module:callable"),
                        ("no_such_module_x:load", "cannot resolve"),
                        ("test_torch_serve:missing", "cannot resolve")):
        with pytest.raises(ValueError, match=match):
            tapi.load_tokenizer(spec, ckpt)
    with pytest.raises(ValueError, match="wire"):
        worker_mod.ModelWorker("", "", "tiny", register=False, wire="yuv")


# -- the launch counters under threads --------------------------------------

def test_launch_counter_is_exact_under_threads():
    """count_launch from 8 threads with a short switch interval: no
    increment is lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(20000):
                _build.count_launch(wrapper)
        _concurrently(*([bump] * 8))
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 8 * 20000

