#!/usr/bin/env python3
"""Mutation check of the attention kernels (K2's LSE, K8, K9, K10), on an
NVIDIA GPU: each mutant is a copy of the port and its tests in the
system's temporary directory with one deliberate fault in a CUDA source,
and the kernel's tests in tests/test_torch_cuda.py (those whose names
match the mutant's filter) must fail on every mutant. Prints one line per
mutant with pytest's summary and exits non-zero if a mutant survives. The
repository itself is not modified. Usage, from the repository root:

    python3 scripts/mutation_check_attention.py
"""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path("videollama2_tpu_torch/csrc")
# name -> (source, text, its replacement, pytest -k filter of the tests)
MUTANTS = {
    "K9 causal q-tile start one tile late": ("flash_attention_bwd.cu",
        "const int qt_begin = kCausal ? k0 / kBlockQ : 0;",
        "const int qt_begin = kCausal ? k0 / kBlockQ + 1 : 0;", "flash"),
    "K9 diagonal excluded": ("flash_attention_bwd.cu",
        "if (kCausal) keep = keep && key <= q0 + lq;",
        "if (kCausal) keep = keep && key < q0 + lq;", "flash"),
    "K8 delta not subtracted": ("flash_attention_bwd.cu",
        "s[n][e] = pe * (dp[n][e] - delta[e >> 1]) * p.scale;  // ds",
        "s[n][e] = pe * dp[n][e] * p.scale;  // ds", "flash"),
    "K8 delta summed over half the head dim": ("flash_attention_bwd.cu",
        "    s += __shfl_xor_sync(0xffffffffu, s, 2);\n    delta[r] = s;",
        "    delta[r] = s;", "flash"),
    "K2 lse without log(l)": ("attention_tile.cuh",
        "= m_run[r] + logf(l);", "= m_run[r];", "flash"),
    "K10 loads head 2p's rows for both heads": (
        "encoder_attention_pairs.cu",
        "head * head_stride + cc * 8", "cc * 8", "pairs"),
    "K10 head 2p + 1 scores against head 2p's keys": (
        "encoder_attention_pairs.cu",
        "softmax_tile_step<DK, false>(qf, ks + head * kTile,",
        "softmax_tile_step<DK, false>(qf, ks,", "pairs"),
    "K10 drops the ragged edge's last key": (
        "encoder_attention_pairs.cu",
        "key_tiles<false>(p.Sk, valid, q0)",
        "key_tiles<false>(p.Sk - 1, valid, q0)", "pairs"),
}


def main() -> int:
    survivors = 0
    for name, (fname, old, new, tests) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            dst = Path(tmp) / "repo"
            for part in ("videollama2_tpu_torch", "tests"):
                shutil.copytree(part, dst / part,
                                ignore=shutil.ignore_patterns(
                                    "build", "__pycache__"))
            shutil.copy("pyproject.toml", dst)
            f = dst / SRC / fname
            text = f.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the pattern is not in {fname} once")
            f.write_text(text.replace(old, new))
            r = subprocess.run(
                [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
                 "tests/test_torch_cuda.py", "-q", "-k", tests, "-p",
                 "no:cacheprovider"], cwd=dst, capture_output=True, text=True)
        out = r.stdout.strip()
        tail = out.splitlines()[-1] if out else r.stderr[-300:]
        survivors += r.returncode == 0
        print(f"{name}: rc {r.returncode}: {tail}", flush=True)
    print(f"{survivors} of {len(MUTANTS)} mutants survived")
    return 1 if survivors else 0


if __name__ == "__main__":
    sys.exit(main())
