"""Manually register a worker with the controller.

Parity: reference serve/register_worker.py:19-26.
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--controller-address", default="http://localhost:10000")
    ap.add_argument("--worker-name", required=True)
    ap.add_argument("--check-heart-beat", action="store_true")
    args = ap.parse_args()

    req = urllib.request.Request(
        args.controller_address + "/register_worker",
        data=json.dumps({"worker_name": args.worker_name,
                         "check_heart_beat": args.check_heart_beat,
                         "worker_status": None}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200


if __name__ == "__main__":
    main()
