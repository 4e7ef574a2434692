#!/usr/bin/env python3
"""The LLM's flash-attention kernels on an NVIDIA GPU, at chip_smoke.py's
cases: K2 (`flash_attention`) at the two prefills (q [4, 1664, 32, 128] on
8 kv heads, Mistral-7B; q [4, 1408, 28, 128] on 4, Qwen2-7B; causal,
ragged valid_len) and, with its LSE, at the training shape (q
[8, 2048, 32, 128], valid_len over 1400-2048), and K8 (dq) and K9 (dk/dv)
at the training shape.

Each kernel is checked against its plain PyTorch version and timed with
CUDA events behind a spin kernel (chip_smoke.check_kernel and
chip_smoke.check_training_attention), beside its bound and torch's
scaled_dot_product_attention (forward, and backward for K8 and K9) as the
library yardstick.

--tree DIR takes the port and chip_smoke.py from another checkout (for an
A/B of two commits in one run: unpack the other commit into a directory
and time both, in turns).

Usage, from the repository root, on a machine with a CUDA GPU:

    python3 scripts/profile_torch_flash.py [--tree DIR]

Prints the card's name and power limit, a line per case and one JSON line
of the results.
"""

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_flash: needs an NVIDIA GPU")
    import chip_smoke as cs
    from videollama2_tpu_torch.ops import flash_attention as k2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": smi, "tree": tree}
    tower, prefill = cs.attention_cases(gen)
    del tower
    out["flash_attention"] = cs.check_kernel(
        "flash_attention", k2.flash_attention, k2.flash_attention_plain,
        prefill, cs.K2_TOL)
    del prefill
    torch.cuda.empty_cache()
    out["training"] = cs.check_training_attention(gen, k2)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
