"""Build the media layer's C++ helpers with g++ at first use and load them
with ctypes.

The libraries come from `media/csrc/`: `video_decoder.cc` (libavcodec,
libavformat and libswscale: the container reader of media/video_reader.py)
and, with no dependency, `png_unfilter.cc`, `jpeg_decode.cc`,
`webp_decode.cc` and `tiff_lzw.cc` (the still readers of
media/image_io.py, media/webp.py and media/tiff.py), `gif_lzw.cc` (GIF
frames) and `resample.cc` (PIL's bicubic resize for
media/preprocess.py). Each lands in `csrc/build/<hash>/`, keyed on a hash of
its source, the flags and the libraries, so an edited source rebuilds and
an unchanged one is reused; the build writes under a temporary name and
renames into place, so processes that build at once never load a
half-written library.

Nothing here runs at import time. Where a build or a load fails (no g++,
or no libavcodec headers on the host), `load` raises a RuntimeError that
names what is missing and the compiler's first error line, and raises the
same error again on later calls without rebuilding.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = CSRC / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread",
             "-ffp-contract=off")

_lock = threading.Lock()
_loaded: dict = {}   # name -> CDLL or the RuntimeError of its build


def library_path(source: str, libs=()) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / (Path(source).stem + ".so")


def _first_error(log: str) -> str:
    lines = [ln for ln in log.splitlines() if ln.strip()]
    for ln in lines:
        if "error" in ln.lower():
            return ln.strip()
    return lines[0].strip() if lines else "(no compiler output)"


def build(source: str, libs=()) -> Path:
    """Compile csrc/<source> into its hashed path unless it exists."""
    out = library_path(source, libs)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the media helpers are built "
                           "from media/csrc at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        lib = Path(tmpdir) / "lib.so"
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(lib), str(CSRC / source),
             *(f"-l{x}" for x in libs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(_first_error(proc.stderr + proc.stdout))
        os.replace(lib, out)
    return out


def load(source: str, libs=(), needs: str = "") -> ctypes.CDLL:
    """The loaded library of csrc/<source>, built on first call. `needs`
    names what the build requires besides g++ (e.g. "libavcodec"), for the
    error raised when it fails."""
    with _lock:
        got = _loaded.get(source)
        if got is None:
            try:
                got = ctypes.CDLL(str(build(source, libs)))
            except (RuntimeError, OSError) as e:
                what = f"g++ and {needs}" if needs else "g++"
                got = RuntimeError(f"cannot build media/csrc/{source} "
                                   f"(needs {what}): {e}")
            _loaded[source] = got
    if isinstance(got, RuntimeError):
        raise got
    return got
