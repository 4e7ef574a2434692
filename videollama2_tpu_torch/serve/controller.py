"""Serving controller: worker registry, liveness, dispatch, stream proxy.

Parity: reference videollama2/serve/controller.py:28-298 — same HTTP API
(`/register_worker`, `/refresh_all_workers`, `/list_models`,
`/get_worker_address`, `/receive_heart_beat`, `/worker_generate_stream`,
`/worker_get_status`), heartbeat expiry, and the LOTTERY / SHORTEST_QUEUE
dispatch policies — rebuilt on the stdlib HTTP server (FastAPI/uvicorn are
not in this image; the wire format is unchanged, JSON bodies + \0-delimited
streaming chunks).
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from ..constants import (CONTROLLER_HEART_BEAT_EXPIRATION,
                         WORKER_HEART_BEAT_INTERVAL)
from ..utils.logging import build_logger

logger = build_logger("controller", "controller.log")


class DispatchMethod(enum.Enum):
    LOTTERY = "lottery"
    SHORTEST_QUEUE = "shortest_queue"

    @classmethod
    def from_str(cls, name: str) -> "DispatchMethod":
        for m in cls:
            if m.value == name:
                return m
        raise ValueError(f"Invalid dispatch method: {name}")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self._lock = threading.Lock()
        self._parent_addr: Optional[str] = None
        self._self_addr: Optional[str] = None
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True)
        self._hb_thread.start()

    # -- hierarchy (controller-as-worker) ------------------------------------

    def aggregate_status(self) -> dict:
        """This controller viewed as one worker: union of models, summed
        speed/queue (reference controller.py:218-236 — hierarchical mode
        for connecting isolated sub-networks)."""
        models, speed, qlen = set(), 0, 0
        with self._lock:
            workers = list(self.worker_info.values())
        for info in workers:
            models.update(info.model_names)
            speed += info.speed
            qlen += info.queue_length
        return {"model_names": sorted(models), "speed": speed,
                "queue_length": qlen}

    def register_to_parent(self, self_addr: str, parent_addr: str) -> bool:
        """Register this controller as a worker of a parent controller and
        start heartbeating; the parent then proxies generate streams here,
        which this controller re-dispatches to its own workers."""
        self._self_addr = self_addr
        self._parent_addr = parent_addr
        ok = self._send_parent_register()
        threading.Thread(target=self._parent_heartbeat_loop,
                         daemon=True).start()
        return ok

    def _send_parent_register(self) -> bool:
        try:
            body = json.dumps({
                "worker_name": self._self_addr, "check_heart_beat": True,
                "worker_status": self.aggregate_status()}).encode()
            req = urllib.request.Request(
                self._parent_addr + "/register_worker", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=5):
                return True
        except Exception as e:
            logger.error(f"Parent register fails: {self._parent_addr}, {e}")
            return False

    def _parent_heartbeat_loop(self) -> None:
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                body = json.dumps({
                    "worker_name": self._self_addr,
                    "queue_length": self.aggregate_status()["queue_length"],
                }).encode()
                req = urllib.request.Request(
                    self._parent_addr + "/receive_heart_beat", data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=5) as r:
                    if not json.loads(r.read()).get("exist", False):
                        self._send_parent_register()
            except Exception as e:
                logger.error(f"Parent heartbeat fails: {e}")
                self._send_parent_register()

    # -- registry ----------------------------------------------------------

    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        if worker_status is None:
            worker_status = self._get_worker_status(worker_name)
        if worker_status is None:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status.get("speed", 1),
                queue_length=worker_status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time())
        logger.info(f"Register done: {worker_name}, {worker_status}")
        return True

    def _get_worker_status(self, worker_name: str) -> Optional[dict]:
        try:
            req = urllib.request.Request(worker_name + "/worker_get_status",
                                         data=b"{}", method="POST")
            with urllib.request.urlopen(req, timeout=5) as r:
                return json.loads(r.read())
        except Exception as e:
            logger.error(f"Get status fails: {worker_name}, {e}")
            return None

    def refresh_all_workers(self) -> None:
        with self._lock:
            old = dict(self.worker_info)
            self.worker_info = {}
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                logger.info(f"Remove stale worker: {name}")

    def list_models(self) -> List[str]:
        names = set()
        with self._lock:
            for info in self.worker_info.values():
                names.update(info.model_names)
        return sorted(names)

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.worker_info:
                return False
            self.worker_info[worker_name].queue_length = queue_length
            self.worker_info[worker_name].last_heart_beat = time.time()
        return True

    def _heartbeat_loop(self) -> None:
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            self._remove_stale_workers()

    def _remove_stale_workers(self) -> None:
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self._lock:
            dead = [n for n, info in self.worker_info.items()
                    if info.check_heart_beat and info.last_heart_beat < expire]
            for n in dead:
                del self.worker_info[n]
                logger.info(f"Remove stale worker: {n}")

    # -- dispatch ----------------------------------------------------------

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [(n, info) for n, info in self.worker_info.items()
                          if model_name in info.model_names]
        if not candidates:
            return ""
        if self.dispatch_method == DispatchMethod.LOTTERY:
            speeds = np.array([i.speed for _, i in candidates],
                              dtype=np.float32)
            total = float(speeds.sum())
            if total <= 0:
                return ""
            pt = np.random.uniform(0, total)
            idx = int(np.searchsorted(np.cumsum(speeds), pt))
            return candidates[min(idx, len(candidates) - 1)][0]
        # shortest queue, normalized by speed
        norm = [i.queue_length / max(i.speed, 1e-6) for _, i in candidates]
        idx = int(np.argmin(norm))
        name = candidates[idx][0]
        with self._lock:
            if name in self.worker_info:
                self.worker_info[name].queue_length += 1
        logger.info(f"names: {[n for n, _ in candidates]}, "
                    f"queue_lens: {norm}, ret: {name}")
        return name

    def worker_api_generate_stream(self, params: dict):
        """Proxy a generate stream from the chosen worker (yields bytes)."""
        addr = self.get_worker_address(params["model"])
        if not addr:
            yield json.dumps({"text": "", "error_code": 2}).encode() + b"\0"
            return
        try:
            req = urllib.request.Request(
                addr + "/worker_generate_stream",
                data=json.dumps(params).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=100) as r:
                while True:
                    chunk = r.read(4096)
                    if not chunk:
                        break
                    yield chunk
        except Exception:
            yield json.dumps({"text": "", "error_code": 1}).encode() + b"\0"


def make_handler(controller: Controller):
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
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"], data["check_heart_beat"],
                    data.get("worker_status"))
                self._send_json({}, 200 if ok else 400)
            elif self.path == "/refresh_all_workers":
                controller.refresh_all_workers()
                self._send_json({})
            elif self.path == "/list_models":
                self._send_json({"models": controller.list_models()})
            elif self.path == "/get_worker_address":
                self._send_json(
                    {"address": controller.get_worker_address(data["model"])})
            elif self.path == "/receive_heart_beat":
                exists = controller.receive_heart_beat(
                    data["worker_name"], data["queue_length"])
                self._send_json({"exist": exists})
            elif self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in controller.worker_api_generate_stream(data):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            elif self.path == "/worker_get_status":
                # aggregate (controller-as-worker, controller.py:218-236)
                self._send_json(controller.aggregate_status())
            else:
                self._send_json({"error": "unknown endpoint"}, 404)

    return Handler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=10000)
    ap.add_argument("--dispatch-method", default="shortest_queue",
                    choices=["lottery", "shortest_queue"])
    ap.add_argument("--controller-address", default=None,
                    help="parent controller URL: register this controller "
                         "as one of its workers (hierarchical multi-cluster "
                         "mode, reference controller.py:218-236)")
    ap.add_argument("--self-address", default=None,
                    help="URL the parent should reach this controller at "
                         "(default http://<host>:<port>)")
    args = ap.parse_args()
    controller = Controller(args.dispatch_method)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(controller))
    if args.controller_address:
        self_addr = args.self_address or f"http://{args.host}:{args.port}"
        controller.register_to_parent(self_addr, args.controller_address)
    logger.info(f"controller listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
