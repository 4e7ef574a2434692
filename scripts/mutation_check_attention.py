#!/usr/bin/env python3
"""Mutation check of the attention kernels (K1, K2, K3, K8, K9, K10) and
of the split-K core of the weight-only decode matmuls (K4, K5, K6,
K7), on an NVIDIA GPU:
each mutant is a copy of the port and its tests in the
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
MUTANT_TIMEOUT_S = 600  # a build and the filtered tests take ~1-2 min
# the split-K core's sum over a tile's splits (splitk_matmul.cuh)
_SUM_SPLIT = "if (sp < p.splits) {\n          sum[w].x"
# name -> (source, text, its replacement, pytest -k filter of the tests)
MUTANTS = {
    "K9 causal q-tile start one tile late": ("flash_attention_dkv.cu",
        "qt_begin = causal ? k0 / kBlockM : 0;",
        "qt_begin = causal ? k0 / kBlockM + 1 : 0;", "flash"),
    "K9 diagonal excluded": ("flash_attention_dkv.cu",
        "(!kCausal || key <= query)", "(!kCausal || key < query)", "flash"),
    "K9 drops one query head of the group": ("flash_attention_dkv.cu",
        "n = k0 < valid ? G * n_qt : 0;",
        "n = k0 < valid ? (G - 1) * n_qt : 0;", "flash"),
    "K9 skips the zero store past valid_len": ("flash_attention_dkv.cu",
        "if (key >= p.Sk) continue;",
        "if (key >= p.Sk || steps.n == 0) continue;", "flash"),
    "K8 delta not subtracted": ("flash_attention_bwd.cu",
        "dp[n][e] = s[n][e] * (dp[n][e] - delta[e >> 1]) * scale;  // dS",
        "dp[n][e] = s[n][e] * dp[n][e] * scale;  // dS", "flash"),
    "K8 delta summed over half the head dim": ("flash_attention_bwd.cu",
        "    sum += __shfl_xor_sync(0xffffffffu, sum, 2);\n    g.delta[r]",
        "    g.delta[r]", "flash"),
    "K8 diagonal excluded": ("flash_attention_bwd.cu",
        "(!kCausal || key <= query)", "(!kCausal || key < query)", "flash"),
    "K8 drops the log2 e factor on lse": ("flash_attention_bwd.cu",
        "p.lse[rows + row] * vl2_tower::kLog2e", "p.lse[rows + row]",
        "flash"),
    "K8 masks only each warpgroup's last tile": ("flash_attention_bwd.cu",
        "(kCausal && k_last > first_row)",
        "(kCausal && k_last > first_row + 64)", "flash"),
    "K8 multiplies dS by the K of the tile that just landed": (
        "flash_attention_bwd.cu", "issue_dq(kt - 1);", "issue_dq(kt);",
        "flash"),
    "K2 lse without log(l)": ("flash_attention.cu",
        "m * kLn2 + logf(l)", "m * kLn2", "flash"),
    "K2 diagonal excluded": ("flash_attention.cu",
        "(!kCausal || col <= row)", "(!kCausal || col < row)", "flash"),
    "K2 multiplies the ring stage after the one that landed": (
        "flash_attention.cu",
        "make_desc(stage(kt), 16, 1024, kSwizzle128B)",
        "make_desc(stage(kt + 1), 16, 1024, kSwizzle128B)", "flash"),
    "K2 masks no tile but the last when valid_len is 0": (
        "flash_attention.cu", "const bool all_masked = valid == 0;",
        "const bool all_masked = false;", "flash"),
    "K10 head 2p + 1 scores against head 2p's keys": (
        "encoder_attention_pairs.cu",
        "make_desc(st + c * L::kKVHead, 16, 1024, kSwizzle128B)",
        "make_desc(st, 16, 1024, kSwizzle128B)", "pairs"),
    "K10 multiplies P by V of the tile that just landed": (
        "encoder_attention_pairs.cu", "issue_pv<kBlockK / 8>(kt - 1);",
        "issue_pv<kBlockK / 8>(kt);", "pairs"),
    "K10 drops the ragged edge's last key": (
        "encoder_attention_pairs.cu",
        "vl2_tower::key_tiles(p.S, valid)",
        "vl2_tower::key_tiles(p.S - 1, valid)", "pairs"),
    "K10 overwrites Q K^T with D 72's tail lanes": (
        "encoder_attention_pairs.cu",
        "wgmma_ss<kNs * 8>(d, dq_tail + mt * (64 * 32 >> 4), k_tail, 1);",
        "wgmma_ss<kNs * 8>(d, dq_tail + mt * (64 * 32 >> 4), k_tail, 0);",
        "pairs"),
    "K1 multiplies the ring stage after the one that landed": (
        "encoder_attention.cu", "const int stage = kt % kStages;",
        "const int stage = (kt + 1) % kStages;", "encoder_attention_cuda"),
    "K1 drops the ragged edge's last key": (
        "encoder_attention.cu", "key_tiles(p.S, valid)",
        "key_tiles(p.S - 1, valid)", "encoder_attention_cuda"),
    "K3 leaves the v scale out of p": (
        "decode_attention.cu", "pin = pe * s_vs[j];", "pin = pe;",
        "decode_attention"),
    "K3 skips the last row of a chunk": (
        "decode_attention.cu", "const int rows = min(kChunk, p.write_pos - r0);",
        "const int rows = min(kChunk - 1, p.write_pos - r0);",
        "decode_attention"),
    "K5 drops the last split's partial": (
        "splitk_matmul.cuh", _SUM_SPLIT, _SUM_SPLIT.replace(
            "sp < p.splits", "sp < p.splits - 1"), "ffn_q8"),
    "K5 skips the up scale": (
        "splitk_matmul.cuh",
        "const float uv = u * load_scale<kF32>(us, n);",
        "const float uv = u;", "ffn_q8"),
    "K5 multiplies the ring stage after the one that landed": (
        "splitk_matmul.cuh", "const int stage = it % kStages;",
        "const int stage = (it + 1) % kStages;", "ffn_q8"),
    "K4 skips its scale": (
        "splitk_matmul.cuh", "    return gv;\n", "    return g;\n",
        "matmul_q8"),
    "K7 swaps the x pieces of the low and high nibbles": (
        "splitk_matmul.cuh", "piece * (p.Din / 2)",
        "(1 - piece) * (p.Din / 2)", "ffn_q4"),
    "K7 drops the -8 offset of its nibbles": (
        "splitk_matmul.cuh", '"r"(0xC308C308u)', '"r"(0xC300C300u)',
        "ffn_q4"),
    "K6 reads its folded int4 pack as int8": (
        "decode_matmul_q4.cu", "vl2_sk::matmul<true>(x, w, s, y",
        "vl2_sk::matmul<false>(x, w, s, y", "matmul_q4"),
    "K7 drops the last split's partial": (
        "splitk_matmul.cuh", _SUM_SPLIT, _SUM_SPLIT.replace(
            "sp < p.splits", "sp < p.splits - 1"), "ffn_q4"),
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
            try:
                r = subprocess.run(
                    [sys.executable, "-m", "pytest", "--noconftest", "-m",
                     "cuda", "tests/test_torch_cuda.py", "-q", "-k", tests,
                     "-p", "no:cacheprovider"], cwd=dst, capture_output=True,
                    text=True, timeout=MUTANT_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                # a mutant that stalls a kernel fails its tests
                print(f"{name}: killed after {MUTANT_TIMEOUT_S} s", flush=True)
                continue
        out = r.stdout.strip()
        tail = out.splitlines()[-1] if out else r.stderr[-300:]
        survivors += r.returncode == 0
        print(f"{name}: rc {r.returncode}: {tail}", flush=True)
    print(f"{survivors} of {len(MUTANTS)} mutants survived")
    return 1 if survivors else 0


if __name__ == "__main__":
    sys.exit(main())
