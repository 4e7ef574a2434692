"""CLI for the port's quantization-accuracy harness
(videollama2_tpu_torch/eval/quant_accuracy.py), beside
scripts/quant_accuracy.py.

Reads a checkpoint directory in the released VideoLLaMA2 layout through
the port's loader (checkpoint/convert_hf), takes its LLM in bf16 and prints
the drift table of every quantized configuration (int8 / int4 weights,
W8A8 prefill, int8 KV cache and their combinations) against the bf16
reference, over seeded random prompts:

  python scripts/quant_accuracy_torch.py --model-path /path/to/ckpt
  python scripts/quant_accuracy_torch.py --model-path CKPT --device cpu \\
      --steps 8 --prompts 2 --bucket 48 --json

Runs on the GPU by default (the packed variants decode on the layered
decode kernels); --device cpu runs their plain versions.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def seeded_prompts(vocab_size: int, n: int, bucket: int) -> list:
    """n prompts, BOS then 8 to bucket/2 - 1 random ids (scripts/
    quant_accuracy.py's, seed 0)."""
    rng = np.random.default_rng(0)
    return [np.concatenate([[1], rng.integers(
        4, vocab_size - 1, rng.integers(8, bucket // 2))])
        for _ in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True,
                    help="checkpoint directory in the released layout")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--bucket", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from videollama2_tpu_torch.checkpoint import convert_hf
    from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
    from videollama2_tpu_torch.eval import quant_accuracy as qa

    cfg, tree = convert_hf.load_videollama2(args.model_path)
    params = params_from_jax(tree, cfg)["llm"]
    del tree
    prompts = seeded_prompts(cfg.llm.vocab_size, args.prompts, args.bucket)
    # the cache holds the bucket and the decoded steps, in 256-row blocks
    max_len = -(-(args.bucket + args.steps) // 256) * 256
    results = qa.measure(params, cfg.llm, prompts, steps=args.steps,
                         bucket=args.bucket, max_len=max_len,
                         dtype=torch.bfloat16, device=args.device)
    if args.json:
        print(json.dumps(results, indent=2))
    else:
        print(qa.format_table(results))
    return results


if __name__ == "__main__":
    main()
