"""The engine's span recorder (smolvision_tpu_torch/runtime/perf.py) on the
CPU: nesting, counts and self time on a scripted clock, the counters the
spans feed, and the profiler ranges, which exist only while the switch is
on."""

import pytest
import torch

from smolvision_tpu_torch.runtime import perf as perf_mod
from smolvision_tpu_torch.runtime.engine import PerfStats


@pytest.fixture
def clock(monkeypatch):
    """perf_counter_ns read from a script of ms values, in order."""
    script = []
    monkeypatch.setattr(perf_mod.time, "perf_counter_ns", lambda: int(script.pop(0) * 1e6))
    return script


def test_span_nesting_counts_and_self_time(clock):
    perf = PerfStats()
    clock += [0, 10, 40, 50, 60, 100]
    with perf.span("serve.call") as call:
        with perf.span("serve.wave"):
            pass
        with perf.span("serve.wave"):
            pass
    assert call.ms == pytest.approx(100.0)
    outer, inner = perf.spans["serve.call"], perf.spans["serve.wave"]
    assert (outer.count, inner.count) == (1, 2)
    assert outer.host_ms == pytest.approx(100.0) and outer.self_ms == pytest.approx(60.0)
    assert inner.host_ms == pytest.approx(40.0) and inner.self_ms == pytest.approx(40.0)
    assert outer.device_ms == inner.device_ms == 0.0


def test_counters_fed_by_spans(clock):
    """`into` takes the host ms where no events were recorded (the CPU);
    wait spans sum into host_wait_ms; a device span records nothing on the
    CPU, so its record keeps device_ms None; the captures of every kind sum
    the per-kind counters; a span open across a reset closes into the new
    counters."""
    perf = PerfStats()
    clock += [0, 5, 10, 12, 20, 27, 30, 31]
    with perf.span("front.mel", device=True, into="mel_ms"):
        pass
    with perf.span("decode.wait_read"):
        pass
    record = {"shadow": True, "device_ms": None}
    with perf.span("serve.wave", device=True, record=record):
        pass
    perf.serving_waves.append(record)
    assert perf.mel_ms == pytest.approx(5.0) and perf.host_wait_ms == pytest.approx(2.0)
    perf.settle_mel()
    assert record["device_ms"] is None and perf.batch_decode_device_ms == 0.0
    assert perf.encode_device_ms == perf.decode_device_ms == 0.0
    # the captures of every kind, from the per-kind counters
    perf.graph_captures, perf.graph_capture_ms = 2, 30.0
    perf.prefill_captures, perf.prefill_capture_ms = 3, 4.5
    assert (perf.captures, perf.capture_ms) == (5, pytest.approx(34.5))
    with perf.span("stream.session"):
        perf.reset()
    assert perf.spans["stream.session"].host_ms == pytest.approx(1.0)
    assert set(perf.spans) == {"stream.session"} and perf.mel_ms == 0.0


def _profiled_names(perf, on: bool, made: list) -> set:
    was = perf_mod.profile_ranges(on)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with perf.span("serve.wave", arg=lambda: made.append(1) or {"wave": 0}):
                torch.ones(8).sum()
            with perf.span("stream.encode", arg=3):
                pass
    finally:
        perf_mod.profile_ranges(was)
    return {e.name for e in prof.events()}


def test_ranges_reach_the_profiler_only_when_switched_on():
    perf = PerfStats()
    made = []
    assert perf_mod.profile_ranges(False) is False     # off unless turned on
    off = _profiled_names(perf, False, made)
    assert "aten::sum" in off and not any(n.startswith("smolvision.") for n in off)
    assert not made      # a span's argument is made only for a range
    assert {"smolvision.serve.wave", "smolvision.stream.encode"} <= _profiled_names(
        perf, True, made)
    assert made == [1]
    assert perf_mod.profile_ranges(False) is False     # restored
    assert perf.spans["serve.wave"].count == 2
