"""Web chat UI: single-page HTML client + streaming backend (port of
videollama2_tpu/serve/web_server.py).

Replaces the reference's gradio web servers (serve/gradio_web_server.py and
gradio_web_server_adhoc.py). Same topology: the page talks to this server,
which either proxies to a controller-managed worker (multi-model mode,
--controller-address) or serves an in-process model (adhoc mode,
--model-path, with a --tokenizer factory). Conversations and votes are
logged to LOGDIR as JSON lines (gradio_web_server.py:32-35,338-349 parity).
An uploaded file is spooled to a temporary file for the processors and
removed after the request.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import tempfile
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..constants import LOGDIR
from ..inference import api as api_lib
from ..utils.logging import build_logger

logger = build_logger("web_server", "web_server.log")

PAGE = """<!DOCTYPE html>
<html><head><title>VideoLLaMA2</title><style>
body { font-family: sans-serif; max-width: 820px; margin: 2em auto; }
#chat { border: 1px solid #ccc; min-height: 320px; padding: 1em;
        white-space: pre-wrap; }
.user { color: #06c; } .bot { color: #222; } .sys { color: #999; }
textarea { width: 100%; } button { margin-top: .5em; }
</style></head><body>
<h2>VideoLLaMA2</h2>
<div id="chat"></div>
<p><input type="file" id="media" accept="image/*,video/*"></p>
<textarea id="msg" rows="3" placeholder="Ask about the image/video..."></textarea>
<button onclick="send()">Send</button>
<button onclick="regenerate()">&#128257; Regenerate</button>
<button onclick="clearChat()">&#128465; Clear</button>
<button onclick="vote(1)">&#128077;</button>
<button onclick="vote(-1)">&#128078;</button>
<script>
let history = [];       // [user, assistant] pairs (gradio state parity)
let media = null;       // {media_b64, media_name} persisted across turns
async function run(msg) {
  const chat = document.getElementById('chat');
  chat.innerHTML += '<div class="user">USER: ' + msg + '</div>';
  const body = {prompt: msg, history: history};
  if (media) Object.assign(body, media);
  const div = document.createElement('div');
  div.className = 'bot'; div.textContent = 'ASSISTANT: ...';
  chat.appendChild(div);
  const resp = await fetch('/generate', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(body)});
  const reader = resp.body.getReader();
  let text = '', buffer = '';
  const dec = new TextDecoder();
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buffer += dec.decode(value, {stream: true});
    const parts = buffer.split('\\0');
    buffer = parts.pop();
    for (const p of parts) {
      if (!p) continue;
      const d = JSON.parse(p);
      text = d.text;
      div.textContent = 'ASSISTANT: ' + text;
    }
  }
  history.push([msg, text]);
}
async function send() {
  const file = document.getElementById('media').files[0];
  if (file) {  // new upload resets the conversation (adhoc-server heuristic)
    const buf = await file.arrayBuffer();
    media = {media_b64: btoa(String.fromCharCode(...new Uint8Array(buf))),
             media_name: file.name};
    history = [];
    document.getElementById('media').value = '';
  }
  await run(document.getElementById('msg').value);
}
async function regenerate() {
  // drop the last exchange and re-ask the same question
  // (gradio_web_server.py regenerate flow)
  if (!history.length) return;
  const last = history.pop();
  await run(last[0]);
}
function clearChat() {
  history = []; media = null;
  document.getElementById('chat').innerHTML = '';
}
async function vote(v) {
  await fetch('/vote', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({vote: v, history: history})});
}
</script></body></html>"""


class WebBackend:
    def __init__(self, args):
        self.args = args
        self.model = None
        if args.model_path:
            # serving default: the I420 frame wire (media/wire.py)
            self.model, self.processor, self.tokenizer = api_lib.model_init(
                args.model_path, wire=getattr(args, "wire", "i420"),
                tokenizer=api_lib.load_tokenizer(args.tokenizer,
                                                 args.model_path),
                device=getattr(args, "device", "cuda"))

    def generate(self, data: dict):
        self._log("chat", data)
        if self.model is not None:
            yield from self._generate_local(data)
        else:
            yield from self._proxy(data)

    @staticmethod
    def _messages(data: dict):
        """history [[user, assistant], ...] + prompt -> mm_infer message
        list (multi-turn; gradio_web_server.py http_bot conversation-state
        parity)."""
        msgs = []
        for user, assistant in data.get("history") or []:
            msgs.append({"role": "user", "content": user})
            msgs.append({"role": "assistant", "content": assistant})
        msgs.append({"role": "user", "content": data.get("prompt", "")})
        return msgs

    IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")

    def _generate_local(self, data):
        media_b64 = data.get("media_b64")
        media_name = data.get("media_name", "")
        tensor, modal = None, "text"
        if media_b64:
            modal = ("image" if media_name.lower().endswith(self.IMAGE_EXTS)
                     else "video")
            suffix = os.path.splitext(media_name)[1]
            with tempfile.NamedTemporaryFile(suffix=suffix,
                                             delete=False) as f:
                f.write(base64.b64decode(media_b64))
            try:
                tensor = self.processor[modal](f.name)
            finally:
                os.unlink(f.name)
        out = api_lib.mm_infer(tensor, self._messages(data), self.model,
                               self.tokenizer, modal=modal,
                               max_new_tokens=512)
        yield json.dumps({"text": out, "error_code": 0}).encode() + b"\0"

    def _proxy(self, data):
        addr_req = urllib.request.Request(
            self.args.controller_address + "/get_worker_address",
            data=json.dumps({"model": self.args.model_name}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(addr_req, timeout=10) as r:
            addr = json.loads(r.read())["address"]
        if not addr:
            yield json.dumps({"text": "no workers available",
                              "error_code": 2}).encode() + b"\0"
            return
        payload = {"prompt": self._messages(data),
                   "model": self.args.model_name}
        media_b64 = data.get("media_b64")
        if media_b64:
            name = data.get("media_name", "")
            if name.lower().endswith(self.IMAGE_EXTS):
                payload["images"] = [media_b64]
            else:
                payload["videos"] = [media_b64]
                payload["video_name"] = name
        req = urllib.request.Request(
            addr + "/worker_generate_stream",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            while True:
                chunk = r.read(4096)
                if not chunk:
                    break
                yield chunk

    def _log(self, kind: str, payload: dict):
        os.makedirs(LOGDIR, exist_ok=True)
        rec = {"tstamp": time.time(), "type": kind,
               **{k: v for k, v in payload.items() if k != "media_b64"}}
        fn = os.path.join(LOGDIR,
                          f"web-conv-{time.strftime('%Y-%m-%d')}.json")
        with open(fn, "a") as f:
            f.write(json.dumps(rec) + "\n")


def make_handler(backend: WebBackend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s - %s" % (self.address_string(), fmt % args))

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/generate":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in backend.generate(data):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            elif self.path == "/vote":
                backend._log("vote", data)
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--controller-address", default="http://localhost:10000")
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--model-path", default=None,
                    help="serve a model in-process (adhoc mode)")
    ap.add_argument("--tokenizer", default=None, metavar="MODULE:CALLABLE",
                    help="adhoc mode's tokenizer factory, called with the "
                         "model path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--wire", default="i420", choices=("i420", "rgb"),
                    help="host->device frame wire (media/wire.py)")
    args = ap.parse_args()
    backend = WebBackend(args)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(backend))
    logger.info(f"web server on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
