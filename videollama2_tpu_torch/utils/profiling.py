"""Tracing and profiling utilities (port of videollama2_tpu/utils/profiling.py).

StageTimer accumulates wall-clock seconds per named stage (decode, encode,
prefill, the decode loop of the serving path); device_trace captures a
torch.profiler trace (CPU activity, and CUDA activity when the card is
used) exported as a Chrome trace that Perfetto reads; annotate names a
range that shows in that trace, and in an NVTX timeline when CUDA is
initialised.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design
    (one per request/worker)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_s": round(self.totals[name]
                                       / max(self.counts[name], 1), 4)}
                for name in self.totals}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block into
    log_dir/trace.json (Chrome trace format, viewable in Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in device traces: a record_function
    range, and an NVTX range once CUDA is initialised."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
