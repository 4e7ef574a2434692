"""Serving smoke client: stream one prompt through controller -> worker.

Parity: reference serve/test_message.py:9-62 (fixed: the reference imports a
nonexistent `llava.conversation`).
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--controller-address", default="http://localhost:10000")
    ap.add_argument("--worker-address", default=None)
    ap.add_argument("--model-name", required=True)
    ap.add_argument("--message", default="Tell me a story with more than "
                                         "1000 words.")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    args = ap.parse_args()

    if args.worker_address:
        addr = args.worker_address
    else:
        req = urllib.request.Request(
            args.controller_address + "/get_worker_address",
            data=json.dumps({"model": args.model_name}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req) as r:
            addr = json.loads(r.read())["address"]
        if not addr:
            print("No available workers")
            return
        print(f"worker_addr: {addr}")

    payload = {"model": args.model_name, "prompt": args.message,
               "temperature": 0.0, "max_new_tokens": args.max_new_tokens}
    req = urllib.request.Request(
        addr + "/worker_generate_stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    print(f"{args.message}\n", end="")
    buf = b""
    with urllib.request.urlopen(req) as r:
        while True:
            chunk = r.read(1)
            if not chunk:
                break
            if chunk == b"\0":
                if buf:
                    data = json.loads(buf)
                    print("ASSISTANT:", data["text"])
                    buf = b""
            else:
                buf += chunk


if __name__ == "__main__":
    main()
