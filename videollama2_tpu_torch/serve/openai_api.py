"""OpenAI-compatible chat-completions server (port of
videollama2_tpu/serve/openai_api.py).

An `/v1/chat/completions` endpoint (message content parts of type `text`,
`image_url` and `video_url`, with file paths or data URLs; streaming as
server-sent events or one JSON body) and `/v1/models`, over the port's
model: a data-URL image is decoded by the port's still-image reader
(media/image_io.py), a data-URL video is spooled to a temporary file for
the container decoder. Completions go through the session store (prefix
caching for multi-turn chats) or, with dynamic batching, the batcher.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import tempfile
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..inference import api as api_lib
from ..media.image_io import read_image
from ..multimodal.tokenizer import get_model_name_from_path
from ..utils.logging import build_logger

logger = build_logger("openai_api", "openai_api.log")


class OpenAIBackend:
    # class-level default: tests build the backend via __new__
    session_store = None

    def __init__(self, model_path: str, model_name: str = None,
                 dynamic_batch: bool = False, wire: str = "i420",
                 tokenizer=None, preloaded=None, device="cuda"):
        self.model_name = model_name or get_model_name_from_path(model_path)
        if preloaded is not None:
            self.model, self.processor, self.tokenizer = preloaded
        else:
            # serving default: the I420 frame wire (media/wire.py)
            self.model, self.processor, self.tokenizer = api_lib.model_init(
                model_path, wire=wire, tokenizer=tokenizer, device=device)
        self.batcher = None
        self.session_store = None
        if dynamic_batch:
            from .batching import DynamicBatcher
            self.batcher = DynamicBatcher(self.model, self.tokenizer,
                                          max_batch=8)
        else:
            self.session_store = api_lib.SessionStore(cap=2)

    def _extract_media(self, messages):
        """The first media part of the message list; returns (tensor,
        modal, cleaned_messages)."""
        tensor, modal = None, "text"
        cleaned = []
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                cleaned.append({"role": m["role"], "content": content})
                continue
            texts = []
            for part in content:
                t = part.get("type")
                if t == "text":
                    texts.append(part["text"])
                elif t in ("image_url", "video_url") and tensor is None:
                    url = part[t]["url"] if isinstance(part.get(t), dict) \
                        else part.get("url", "")
                    modal = "image" if t == "image_url" else "video"
                    tensor = self._media(url, modal)
            cleaned.append({"role": m["role"], "content": "\n".join(texts)})
        return tensor, modal, cleaned

    def _media(self, url: str, modal: str):
        if not url.startswith("data:"):
            return self.processor[modal](url.replace("file://", ""))
        raw = base64.b64decode(url.split(",", 1)[1])
        if modal == "image":
            return self.processor["image"](read_image(raw))
        with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
            f.write(raw)
        try:
            return self.processor["video"](f.name)
        finally:
            os.unlink(f.name)

    def complete(self, body: dict):
        messages = body.get("messages", [])
        tensor, modal, cleaned = self._extract_media(messages)
        # fold multi-turn into the instruct list the API accepts
        user_turns = [m for m in cleaned if m["role"] != "system"]
        instruct = (user_turns if len(user_turns) > 1
                    else user_turns[0]["content"] if user_turns else "")
        kwargs = dict(
            do_sample=body.get("temperature", 0) not in (0, None),
            temperature=body.get("temperature") or 0.2,
            top_p=body.get("top_p", 0.9),
            max_new_tokens=body.get("max_tokens", 512))
        if self.batcher is not None:
            # continuous batching: concurrent completions share one call
            q = self.batcher.submit(instruct, modal, tensor, **kwargs)
            while True:
                kind, text = q.get()
                if kind == "error":
                    raise RuntimeError(text)
                if kind == "done":
                    return text
        if self.session_store is not None:
            return api_lib.mm_infer_session(
                tensor, instruct, self.model, self.tokenizer,
                self.session_store, modal=modal, **kwargs)
        return api_lib.mm_infer(tensor, instruct, self.model,
                                self.tokenizer, modal=modal, **kwargs)


def make_handler(backend: OpenAIBackend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s - %s" % (self.address_string(), fmt % args))

        def _send_json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/models":
                self._send_json({"object": "list", "data": [
                    {"id": backend.model_name, "object": "model"}]})
            else:
                self._send_json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path != "/v1/chat/completions":
                self._send_json({"error": "not found"}, 404)
                return
            try:
                text = backend.complete(body)
            except Exception as e:  # the request fails, the server goes on
                logger.exception("completion failed")
                self._send_json({"error": {"message": str(e)}}, 500)
                return
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                chunk = {"id": rid, "object": "chat.completion.chunk",
                         "created": int(time.time()),
                         "model": backend.model_name,
                         "choices": [{"index": 0,
                                      "delta": {"role": "assistant",
                                                "content": text},
                                      "finish_reason": None}]}
                self.wfile.write(b"data: " + json.dumps(chunk).encode()
                                 + b"\n\n")
                done = dict(chunk)
                done["choices"] = [{"index": 0, "delta": {},
                                    "finish_reason": "stop"}]
                self.wfile.write(b"data: " + json.dumps(done).encode()
                                 + b"\n\n")
                self.wfile.write(b"data: [DONE]\n\n")
            else:
                self._send_json({
                    "id": rid, "object": "chat.completion",
                    "created": int(time.time()),
                    "model": backend.model_name,
                    "choices": [{"index": 0,
                                 "message": {"role": "assistant",
                                             "content": text},
                                 "finish_reason": "stop"}],
                })

    return Handler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--tokenizer", default=None, metavar="MODULE:CALLABLE",
                    help="tokenizer factory, called with the model path "
                         "(the port imports no tokenizer library)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dynamic-batch", action="store_true",
                    help="continuous batching across concurrent requests")
    ap.add_argument("--wire", default="i420", choices=("i420", "rgb"),
                    help="host->device frame wire (media/wire.py)")
    args = ap.parse_args()
    backend = OpenAIBackend(
        args.model_path, args.model_name, dynamic_batch=args.dynamic_batch,
        wire=args.wire,
        tokenizer=api_lib.load_tokenizer(args.tokenizer, args.model_path),
        device=args.device)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(backend))
    logger.info(f"openai api on http://{args.host}:{args.port}/v1")
    server.serve_forever()


if __name__ == "__main__":
    main()
