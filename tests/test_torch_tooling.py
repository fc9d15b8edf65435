"""The port's tracing and timing helpers (``utils.profiling``,
``utils.timing``), on the CPU: ``StepTimer``'s warmup and summary keys as
the JAX package's, ``device_rate`` on a CPU dispatch and its warning when
k_hi runs are not slower, ``force_completion`` and ``sync``, and an
``annotate`` region's name in the trace file that ``trace`` writes."""
import glob
import json
import time
import warnings

import numpy as np
import pytest
import torch

from nuwa_tpu_torch.utils import profiling, timing

torch.set_num_threads(1)


def test_step_timer_skips_warmup_and_summarises():
    timer = profiling.StepTimer(warmup=2)
    assert timer.summary() == {"steps": 0}
    assert np.isnan(timer.mean) and np.isnan(timer.p50)
    for ms in (60, 60, 2, 4, 6):
        with timer:
            time.sleep(ms / 1e3)
    s = timer.summary()
    assert set(s) == {"steps", "mean_s", "p50_s", "min_s", "max_s"}
    assert s["steps"] == 3 and len(timer.times) == 3
    assert 0.002 <= s["min_s"] <= s["p50_s"] <= s["max_s"] < 0.05
    assert s["mean_s"] == pytest.approx(np.mean(timer.times))
    assert timer.p50 == s["p50_s"] and timer.mean == s["mean_s"]


def test_device_rate_times_a_cpu_dispatch():
    """A dispatch of about 5 ms: the two-point rate is near it (the sleep
    may overshoot on a loaded host)."""
    x = torch.randn(8)

    def dispatch():
        time.sleep(5e-3)
        return x * 2

    rate = timing.device_rate(dispatch, k_lo=2, k_hi=6, reps=2)
    assert 4e-3 < rate < 2e-2


def test_device_rate_warns_when_k_hi_is_not_slower(monkeypatch):
    clock = iter(range(1000))  # every run takes one tick, whatever its k
    monkeypatch.setattr(timing.time, "perf_counter", lambda: float(next(clock)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rate = timing.device_rate(lambda: torch.ones(2), k_lo=2, k_hi=10)
    assert any("k_hi run was not slower" in str(w.message) for w in caught)
    assert rate == pytest.approx(1 / 10)


def test_sync_and_force_completion_read_back_a_scalar():
    t = torch.arange(6.0).reshape(2, 3)
    assert timing.sync(t) == 15.0
    assert profiling.force_completion({"a": [t + 1, None]}) == 1.0


def test_annotated_region_is_in_the_trace(tmp_path):
    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("port_step_region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "port_step_region" for e in events)
    assert any(row.key == "port_step_region" for row in prof.key_averages())
