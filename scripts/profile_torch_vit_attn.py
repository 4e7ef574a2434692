#!/usr/bin/env python3
"""Tower attention on an NVIDIA GPU: the PyTorch port's counterpart of
scripts/profile_vit_attn.py, and the entry point that runs K10.

At the towers' chunk shapes, q/k/v [128, 577, 16, 64] (CLIP-L/336, 128
frames a chunk) and [128, 729, 16, 72] (SigLIP-SO400M/384), bf16 with
every key valid, it times four versions of the same attention with CUDA
events behind a spin kernel (chip_smoke.cuda_ms): the plain PyTorch
version, K1 (`encoder_attention`), K10 (`encoder_attention(...,
pack_pairs=True)`, the head-pair kernel) and one
`torch.nn.functional.scaled_dot_product_attention` call as a yardstick,
beside the bound (chip_smoke.attention_bound: q/k/v read and the output
written once at 3.35 TB/s, or the FLOPs at 989 TFLOP/s), and checks K1 and
K10 against the plain version (chip_smoke.K1_TOL).

With TOWER=1 it times, instead, the CLIP and the SigLIP tower's features
over one 128-frame chunk (seeded random bf16 weights, the bf16 slice's
tower) with real attention and with attention replaced by the identity,
so the attention share of each tower is known.

Usage, from the repository root, on a machine with a CUDA GPU:

    python3 scripts/profile_torch_vit_attn.py
    TOWER=1 python3 scripts/profile_torch_vit_attn.py

Prints the card's name and power limit, a line per measurement and one
JSON line of the results.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import (K1_TOL, attention_bound, cuda_ms,  # noqa: E402
                        sdpa_args)

CHUNK = 128  # frames a tower pass (models/videollama2.VIT_ENCODE_CHUNK)


def _fields(row: dict) -> str:
    return ", ".join(f"{key} {val:.4f}" if isinstance(val, float)
                     else f"{key} {val}" for key, val in row.items()
                     if key != "shape")


def kernels(gen) -> dict:
    """plain / K1 / K10 / SDPA at both towers' chunk shapes."""
    from videollama2_tpu_torch.ops import encoder_attention as k1
    F = torch.nn.functional
    out = {}
    for name, S, D in (("clip", 577, 64), ("siglip", 729, 72)):
        q, k, v = (torch.randn((CHUNK, S, 16, D), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        ref = k1.encoder_attention_plain(q.float(), k.float(), v.float())
        errs = {}
        for label, kw in (("k1", {}), ("k10", {"pack_pairs": True})):
            got = k1.encoder_attention(q, k, v, **kw).float()
            errs[label] = (got - ref).abs().max().item()
            if not errs[label] <= K1_TOL:
                raise RuntimeError(f"{label} at {name}: max_abs_err "
                                   f"{errs[label]} > {K1_TOL}")
        del ref, got
        sq, sk, sv = sdpa_args(q, k, v, None, False)[:3]
        bnd = attention_bound(q, k, None, False, 2, q.nbytes)
        row = {
            "shape": [CHUNK, S, 16, D],
            "plain_ms": cuda_ms(lambda: k1.encoder_attention_plain(q, k, v),
                                iters=3),
            "k1_ms": cuda_ms(lambda: k1.encoder_attention(q, k, v)),
            "k10_ms": cuda_ms(lambda: k1.encoder_attention(
                q, k, v, pack_pairs=True)),
            "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv)),
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "k1_max_abs_err": errs["k1"], "k10_max_abs_err": errs["k10"]}
        print(f"[{name}] q/k/v {row['shape']}: " + _fields(row), flush=True)
        out[name] = row
        del q, k, v, sq, sk, sv
        torch.cuda.empty_cache()
    return out


def towers(gen) -> dict:
    """Each tower's features over one chunk, with real attention and with
    attend() replaced by the identity (the attention share)."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.models import vit
    from videollama2_tpu_torch.ops import attention as attn
    from videollama2_tpu_torch.utils.synthetic import synthetic_vision_params
    out = {}
    for name, preset in (("clip", "videollama2_mistral"),
                         ("siglip", "videollama2_qwen2")):
        vcfg = cfglib.preset(preset).vision
        params = synthetic_vision_params(vcfg, torch.bfloat16, "cuda",
                                         seed=0)
        H = vcfg.image_size
        px = torch.randn((CHUNK, H, H, 3), generator=gen,
                         device="cuda").bfloat16()
        layers = vcfg.select_layer % (vcfg.num_layers + 1)

        def run():
            with torch.inference_mode():
                vit.features(params, vcfg, px)
        real_ms = cuda_ms(run, iters=5)
        real_attend = attn.attend
        attn.attend = lambda q, k, v, **kw: q
        try:
            identity_ms = cuda_ms(run, iters=5)
        finally:
            attn.attend = real_attend
        row = {"frames": CHUNK, "layers": layers, "real_attention_ms": real_ms,
               "identity_attention_ms": identity_ms,
               "attention_ms": real_ms - identity_ms,
               "attention_share": (real_ms - identity_ms) / real_ms,
               "attention_ms_per_layer": (real_ms - identity_ms) / layers}
        print(f"[{name} tower] " + _fields(row), flush=True)
        out[name] = row
        del params, px
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_vit_attn: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    if os.environ.get("TOWER", "0") == "1":
        result = {"towers": towers(gen)}
    else:
        result = {"attention": kernels(gen)}
    print(json.dumps({"device": smi, **result}), flush=True)


if __name__ == "__main__":
    main()
