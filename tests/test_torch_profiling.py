"""The port's utils/profiling.py against the JAX package's: StageTimer's
summary() and dump() (to a string and to a file) equal JAX's for the same
stages under one patched time.perf_counter, and device_trace on the CPU
writes a Chrome trace that holds the annotate ranges around the work."""

import json
import time

import pytest
import torch

from videollama2_tpu.utils import profiling as jprof
from videollama2_tpu_torch.utils import profiling as tprof


def _run(module):
    timer = module.StageTimer()
    for name in ("encode", "prefill", "decode", "decode", "encode"):
        with timer.stage(name):
            pass
    try:
        with timer.stage("failed"):
            raise KeyError(name)
    except KeyError:
        pass
    return timer


def test_stage_timer_matches_jax(monkeypatch, tmp_path):
    """Stage totals, counts and means (rounded to 4 places), a stage that
    raised counted too, in the same JSON."""
    ticks = [0.0, 0.123456, 0.5, 1.00001, 1.25, 2.0, 3.5, 3.75, 4.0,
             4.33333, 5.0, 5.5]
    out = {}
    for name, module in (("jax", jprof), ("port", tprof)):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = _run(module)
        monkeypatch.undo()
        path = tmp_path / f"{name}.json"
        out[name] = (timer.summary(), timer.dump(), timer.dump(str(path)),
                     path.read_text())
    assert out["port"] == out["jax"]
    summary = out["port"][0]
    assert summary["decode"] == {"total_s": 1.0, "count": 2, "mean_s": 0.5}
    assert summary["prefill"]["total_s"] == 0.5
    assert summary["failed"]["count"] == 1
    assert json.loads(out["port"][1]) == summary


@pytest.mark.parametrize("ranges", [("encode",), ("encode", "prefill",
                                                  "decode")])
def test_device_trace_holds_the_annotated_ranges(tmp_path, ranges):
    x = torch.randn(64, 64)
    with tprof.device_trace(str(tmp_path)):
        for name in ranges:
            with tprof.annotate(name):
                x = torch.tanh(x @ x)
    with open(tmp_path / tprof.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    for name in ranges:
        assert names.count(name) == 1, name
    assert any(n and "mm" in n for n in names)
    marks = {e["name"]: e for e in events if e.get("name") in ranges}
    starts = [marks[n]["ts"] for n in ranges]
    assert starts == sorted(starts)
