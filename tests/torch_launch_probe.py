"""The eval "module" of tests/test_torch_launch.py's torchrun run of
scripts/torch/launch_multinode.py: main() writes the argv it was given, its
rank and whether the process group is up to <--out>/rank<RANK>.json.
Imports no JAX."""

import argparse
import json
import os
import sys


def main():
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args, _ = ap.parse_known_args()
    rank = int(os.environ["RANK"])
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump({"argv": sys.argv, "rank": rank,
                   "world": dist.get_world_size(),
                   "backend": dist.get_backend()}, f)
