#!/usr/bin/env python3
"""Decode attention (K3) on an NVIDIA GPU at chip_smoke.py's cases.

Times K3 (`decode_attention_layered`), its plain PyTorch version and one
`torch.nn.functional.scaled_dot_product_attention` call over the same rows
of a bf16 cache (a yardstick) with CUDA events behind a spin kernel, beside
the bound, and checks K3 against the plain version (chip_smoke.K3_TOL):
B 16, 32 query heads on 8 kv heads of 128 over the int8 cache (and a bf16
one, and a window of 1024) at Mistral's bucket, and 28 on 4 over the int8
cache at Qwen2's.

--tree DIR takes the port and chip_smoke.py from another checkout (for an
A/B of two commits in one run: unpack the other commit into a directory
and time both, in turns).

Usage, from the repository root, on a machine with a CUDA GPU:

    python3 scripts/profile_torch_decode_attn.py [--tree DIR]

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
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode_attn: needs an NVIDIA GPU")
    import chip_smoke as cs
    from videollama2_tpu_torch.models.llm import _quantize_kv_rows
    from videollama2_tpu_torch.ops import decode_attention as k3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = (cs.decode_attention_cases(gen, _quantize_kv_rows, k3, 32, 8,
                                       cs.BUCKET, (("int8", None),
                                                   ("bf16", None),
                                                   ("int8", 1024)))
             + cs.decode_attention_cases(gen, _quantize_kv_rows, k3, 28, 4,
                                         cs.QWEN2_BUCKET, (("int8", None),)))
    res = cs.check_kernel("decode_attention", k3.decode_attention_layered,
                          k3.decode_attention_plain, cases, cs.K3_TOL)
    print(json.dumps({"device": smi, "tree": tree, **res}), flush=True)


if __name__ == "__main__":
    main()
