"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process for `sm_90a`,
all started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers: a build takes seconds, not
minutes). The library lands in `csrc/build/<hash>/`, keyed on a hash of
the sources and flags, so an edited kernel rebuilds and an unchanged one is
reused. The build writes to a temporary name and renames it into place, so
concurrent processes never load a half-written library.

Nothing here runs at import time: the modules are imported on hosts without
a GPU or `nvcc`, and a build starts only when a wrapper is handed a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
# ptxas's report of every kernel's registers, shared memory and spills,
# written beside the library by each build
BUILD_LOG = "ptxas.txt"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (see csrc/*.cu); every one returns the
# launch's cudaError_t as an int.
_SIGNATURES = {
    "vl2_encoder_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    "vl2_encoder_attention_pairs": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _L, _L, _L, _L, _L, _L, _L, _L, _L, _F,
                                    _P],
    "vl2_flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P],
    "vl2_flash_attention_bwd_dq": [_P] * 9 + [_I] * 6 + [_L] * 9
                                  + [_F, _I, _P],
    "vl2_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 6 + [_L] * 9
                                   + [_F, _I, _P],
    "vl2_decode_attention": [_P] * 11 + [_I] * 10 + [_F, _P],
    "vl2_matmul_q8": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vl2_ffn_q8_gate_up": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vl2_matmul_q4": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vl2_ffn_q4_gate_up": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU (CUDA toolkit needed)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvl2_kernels.so"


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise with the output of a failure,
    else return the compilers' output."""
    failed, logs = [], []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        logs.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile csrc/*.cu into the hashed library path unless it exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o"
                for src in sorted(CSRC.glob("*.cu"))]
        log = _run([_start([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o",
                            str(obj)])
                    for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)])
        (out.parent / BUILD_LOG).write_text(log)
        lib = Path(tmpdir) / "lib.so"
        _run([_start([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
                      *map(str, objs)])])
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def check_operand(name: str, t, device) -> None:
    """What the attention kernels read: a bf16 [B, S, H, D] tensor on
    `device` whose last axis is contiguous and whose rows start on 16-byte
    boundaries (the kernels load 8 elements a thread). Other strides are
    free, so q/k/v may be column slices of a fused qkv projection."""
    import torch
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be [B, S, H, D], got {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: last axis must be contiguous with rows "
                         f"16-byte aligned, got strides {t.stride()}")
