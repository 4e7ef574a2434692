"""Serving model worker: loads the model, registers to the controller,
streams generations (port of videollama2_tpu/serve/model_worker.py).

Parity: reference videollama2/serve/model_worker.py:85-397 — registration
and 15 s heartbeats with the queue length, a concurrency semaphore
(`--limit-model-concurrency`), base64-image / video-path decode, a keyword
safety gate on the input and the streamed output, and \\0-delimited JSON
chunk streaming with the same `error_code`s — on stdlib HTTP, over the
port's Engine. The worker takes the tokenizer object (`tokenizer=`, as the
port's model_init does) or a `preloaded=(model, processor, tokenizer)`
tuple; its command line names a tokenizer factory (`--tokenizer
module:callable`, inference/api.load_tokenizer). A request whose media
cannot be decoded (a container on a host without the decoder, a JPEG)
gets one chunk with error_code 1.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import tempfile
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, List, Optional

from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..inference import api as api_lib
from ..media import wire as wire_lib
from ..media.image_io import read_image
from ..media.preprocess import (process_image, process_video,
                                process_video_i420)
from ..multimodal.tokenizer import get_model_name_from_path
from ..utils.logging import build_logger, pretty_print_semaphore

logger = build_logger("model_worker", "model_worker.log")

worker_id = str(uuid.uuid4())[:6]

BANNED_WORDS: List[str] = []  # populated via --banned-words-file


def _check_safety(text: str) -> bool:
    low = text.lower()
    return not any(w in low for w in BANNED_WORDS)


def _chunk(text: str, error_code: int) -> bytes:
    return json.dumps({"text": text, "error_code": error_code}).encode() \
        + b"\0"


class ModelWorker:
    # class-level defaults: tests (and any embedder) may build the worker
    # via __new__ + attribute assembly without running __init__
    speculative_k = 0
    session_store = None
    wire = "i420"

    def __init__(self, controller_addr: str, worker_addr: str,
                 model_path: str, model_name: Optional[str] = None,
                 limit_concurrency: int = 5, register: bool = True,
                 num_frames: Optional[int] = None,
                 dynamic_batch: bool = False,
                 speculative_k: int = 0,
                 session_cache: int = 2,
                 preloaded=None,
                 wire: str = "i420",
                 tokenizer=None,
                 device="cuda"):
        # validate before the checkpoint load: a bad wire string must not
        # cost a 7B model_init first
        if wire not in ("i420", "rgb", "fp32"):
            raise ValueError(f"wire must be i420|rgb|fp32, got {wire}")
        self.wire = wire
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name or get_model_name_from_path(model_path)
        if preloaded is not None:
            # share an already-loaded (model, processor, tokenizer): a 7B
            # tree fills much of the card, so an embedder that runs several
            # worker configurations must not load it twice
            self.model, self.processor, self.tokenizer = preloaded
        else:
            logger.info(f"Loading model {self.model_name} on worker "
                        f"{worker_id} ...")
            self.model, self.processor, self.tokenizer = api_lib.model_init(
                model_path, tokenizer=tokenizer, device=device)
        self.batcher = None
        if dynamic_batch:
            from .batching import DynamicBatcher
            self.batcher = DynamicBatcher(self.model, self.tokenizer,
                                          max_batch=8)
        if num_frames:
            self.model.config = self.model.config.replace(
                num_frames=num_frames)
        # the frame wire (media/wire.py): "i420" ships planar YUV 4:2:0
        # (1.5 B/px), "rgb" resized uint8 RGB (3 B/px), "fp32"
        # host-normalized floats (12 B/px)
        self.speculative_k = speculative_k
        self.session_store = None
        if session_cache > 0 and not dynamic_batch:
            # prefix caching for multi-turn chat (inference/api.SessionStore);
            # each cached session holds a KV cache on the device
            self.session_store = api_lib.SessionStore(cap=session_cache)
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.limit_concurrency = limit_concurrency
        self._queue = 0
        self._qlock = threading.Lock()

        if register:
            self.register_to_controller()
            t = threading.Thread(target=self._heartbeat_loop, daemon=True)
            t.start()

    # -- controller plumbing ----------------------------------------------

    def register_to_controller(self):
        logger.info("Register to controller")
        data = {"worker_name": self.worker_addr, "check_heart_beat": True,
                "worker_status": self.get_status()}
        req = urllib.request.Request(
            self.controller_addr + "/register_worker",
            data=json.dumps(data).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        urllib.request.urlopen(req, timeout=5).read()

    def _heartbeat_loop(self):
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            self.send_heart_beat()

    def send_heart_beat(self):
        logger.info(f"Send heart beat. Models: [{self.model_name}]. "
                    f"Semaphore: {pretty_print_semaphore(self.semaphore)}.")
        data = {"worker_name": self.worker_addr,
                "queue_length": self.get_queue_length()}
        try:
            req = urllib.request.Request(
                self.controller_addr + "/receive_heart_beat",
                data=json.dumps(data).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=5) as r:
                exist = json.loads(r.read())["exist"]
            if not exist:
                self.register_to_controller()
        except Exception as e:
            logger.error(f"heart beat error: {e}")

    def get_queue_length(self) -> int:
        with self._qlock:
            return self._queue

    def get_status(self) -> dict:
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.get_queue_length()}

    # -- generation --------------------------------------------------------

    def _decode_media(self, params: dict):
        """Returns (tensor, modal) from a request's base64 images, video
        path or base64 video (model_worker.py:182-203 equivalent)."""
        cfg = self.model.config
        vis_cfg = cfg.vision
        num_frames = cfg.num_frames
        out_dtype = "float32" if self.wire == "fp32" else "uint8"
        images = params.get("images", None)
        video = params.get("video", None)
        audio = params.get("audio", None)
        videos_b64 = params.get("videos", None)
        if videos_b64:
            # a base64-embedded video (clients without a shared
            # filesystem): spooled to a temporary file for the decoder
            name = params.get("video_name", "clip.mp4")
            suffix = os.path.splitext(name)[1] or ".mp4"
            with tempfile.NamedTemporaryFile(suffix=suffix,
                                             delete=False) as f:
                f.write(base64.b64decode(videos_b64[0]))
                video = f.name
        if video:
            # the AV model takes the clip's own audio track beside the
            # frames (reference README.md:130-132) unless the request asks
            # for plain video ("modal": "video")
            want_av = (cfg.audio is not None
                       and params.get("modal", "av") == "av")
            try:
                if self.wire == "i420":
                    tensor = process_video_i420(video, vis_cfg,
                                                num_frames=num_frames)
                else:
                    tensor = process_video(video, vis_cfg,
                                           aspect_ratio=None,
                                           num_frames=num_frames,
                                           out_dtype=out_dtype)
                if want_av:
                    feats = api_lib._prep_av_audio(video, cfg)
                    return {"video": tensor, "audio": feats}, "av"
            finally:
                if videos_b64:
                    os.unlink(video)
            return tensor, "video"
        if audio is not None and cfg.audio is not None:
            # an audio-only request: a .wav or container path
            return audio, "audio"
        if images:
            tensor = process_image(read_image(base64.b64decode(images[0])),
                                   vis_cfg, aspect_ratio=None,
                                   out_dtype=out_dtype)
            if self.wire == "i420":
                tensor = wire_lib.rgb_to_i420(tensor)
            return tensor, "image"
        return None, "text"

    def generate_stream(self, params: dict) -> Iterator[bytes]:
        # `prompt` is a string (single turn) or an mm_infer message list
        # [{role, content}, ...] (multi-turn web/proxy clients)
        prompt = params["prompt"]
        gate_text = prompt if isinstance(prompt, str) else " ".join(
            str(m.get("content", "")) for m in prompt)
        if not _check_safety(gate_text):
            yield _chunk("input violates safety policy.", 1)
            return
        try:
            tensor, modal = self._decode_media(params)
        except (RuntimeError, OSError, ValueError) as e:
            logger.exception("media decoding failed")
            yield _chunk(f"cannot decode the request's media: "
                         f"{type(e).__name__}: {e}", 1)
            return
        kwargs = dict(
            do_sample=bool(params.get("temperature", 0) > 0.001),
            temperature=float(params.get("temperature", 0.2)),
            top_p=float(params.get("top_p", 0.9)),
            max_new_tokens=min(int(params.get("max_new_tokens", 256)), 1024),
            # latency lever for single-stream greedy requests; the engine
            # ignores it for sampled or batched generations
            speculative_k=int(params.get("speculative_k",
                                         self.speculative_k)),
        )

        if self.batcher is not None and modal not in ("av", "audio"):
            # AV and audio requests bypass the batcher (it groups the
            # vision, image and text kinds only)
            yield from self._generate_batched(prompt, modal, tensor, kwargs)
            return

        # stream by chunk: run the engine with a callback
        emitted = {"text": ""}
        stream_q: list = []
        done = threading.Event()

        def stream_cb(b, ids):
            stream_q.append(self.tokenizer.decode(ids,
                                                  skip_special_tokens=True))

        def run():
            try:
                if self.session_store is not None:
                    out = api_lib.mm_infer_session(
                        tensor, prompt, self.model, self.tokenizer,
                        self.session_store, modal=modal,
                        stream_cb=stream_cb, **kwargs)
                else:
                    out = api_lib.mm_infer(tensor, prompt, self.model,
                                           self.tokenizer, modal=modal,
                                           stream_cb=stream_cb, **kwargs)
                emitted["text"] = out
            except Exception as e:  # a request's failure ends only it
                logger.exception("generation failed")
                emitted["error"] = str(e)
            done.set()

        t = threading.Thread(target=run)
        with self._qlock:
            self._queue += 1
        try:
            self.semaphore.acquire()
            t.start()
            while not done.is_set() or stream_q:
                if stream_q:
                    last = stream_q.pop(0)
                    if not _check_safety(last):
                        yield _chunk("output violates safety policy.", 1)
                        return
                    yield _chunk(last, 0)
                else:
                    time.sleep(0.02)
            t.join()
        finally:
            self.semaphore.release()
            with self._qlock:
                self._queue -= 1
        if "error" in emitted:
            yield _chunk("internal error", 1)
        else:
            yield _chunk(emitted["text"], 0)

    def _generate_batched(self, prompt, modal, tensor, kwargs
                          ) -> Iterator[bytes]:
        """Continuous batching (serve/batching.DynamicBatcher): concurrent
        requests share one engine call; tokens stream back per request."""
        with self._qlock:
            self._queue += 1
        try:
            out_q = self.batcher.submit(prompt, modal, tensor, **kwargs)
            while True:
                kind, text = out_q.get()
                if kind == "error":
                    logger.error(f"batched generation failed: {text}")
                    yield _chunk("internal error", 1)
                    return
                if not _check_safety(text):
                    yield _chunk("output violates safety policy.", 1)
                    return
                yield _chunk(text, 0)
                if kind == "done":
                    return
        finally:
            with self._qlock:
                self._queue -= 1


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s - %s" % (self.address_string(), fmt % args))

        def _json_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _send_json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            data = self._json_body()
            if self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream(data):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            elif self.path == "/worker_get_status":
                self._send_json(worker.get_status())
            elif self.path == "/model_details":
                self._send_json(
                    {"context_length":
                     worker.model.config.llm.max_position_embeddings})
            elif self.path == "/count_token":
                p = data.get("prompt", "")
                if not isinstance(p, str):  # message-list prompts
                    p = " ".join(str(m.get("content", "")) for m in p)
                n = len(worker.tokenizer(p).input_ids)
                self._send_json({"count": n, "error_code": 0})
            else:
                self._send_json({"error": "unknown endpoint"}, 404)

    return Handler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--worker-address", default="http://localhost:21002")
    ap.add_argument("--controller-address", default="http://localhost:10000")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--tokenizer", default=None, metavar="MODULE:CALLABLE",
                    help="tokenizer factory, called with the model path "
                         "(the port imports no tokenizer library)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--limit-model-concurrency", type=int, default=5)
    ap.add_argument("--no-register", action="store_true")
    ap.add_argument("--num-frames", type=int, default=None)
    ap.add_argument("--banned-words-file", default=None)
    ap.add_argument("--dynamic-batch", action="store_true",
                    help="continuous batching: group concurrent requests "
                         "into one engine call (serve/batching.py)")
    ap.add_argument("--session-cache", type=int, default=2, metavar="N",
                    help="prefix-cache up to N chat sessions (KV cache "
                         "stays on the device across turns); 0 disables")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="prompt-lookup speculative decoding: verify K "
                         "tokens a pass on greedy single-stream requests")
    ap.add_argument("--wire", default="i420",
                    choices=("i420", "rgb", "fp32"),
                    help="host->device frame wire: planar YUV 4:2:0 "
                         "(1.5 B/px, default), uint8 RGB (3 B/px) or "
                         "host-normalized fp32 (12 B/px); media/wire.py")
    args = ap.parse_args()

    if args.banned_words_file:
        with open(args.banned_words_file) as f:
            BANNED_WORDS.extend(
                w.strip().lower() for w in f if w.strip())

    worker = ModelWorker(args.controller_address, args.worker_address,
                         args.model_path, args.model_name,
                         args.limit_model_concurrency,
                         register=not args.no_register,
                         num_frames=args.num_frames,
                         dynamic_batch=args.dynamic_batch,
                         speculative_k=args.speculative,
                         session_cache=args.session_cache,
                         wire=args.wire,
                         tokenizer=api_lib.load_tokenizer(args.tokenizer,
                                                          args.model_path),
                         device=args.device)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(worker))
    logger.info(f"worker listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
