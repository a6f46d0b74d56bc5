"""The readers of the program's span records (wave_device_ms,
admit_wait_ms.p95) on a synthetic run: their values, and None where the
records lack what they read (the CPU's waves, a program without the
spans)."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness


def _run(waves):
    totals = harness.Totals()
    totals.serving_waves.extend(waves)
    return SimpleNamespace(totals=totals)


def _read(name, waves):
    return harness.load_module("metrics", name).read(_run(waves))


def test_wave_device_ms_is_the_mean_over_waves_with_device_time():
    waves = [{"dispatch_ms": 50.0, "device_ms": 20.0}, {"dispatch_ms": 1.5, "device_ms": 4.0},
             {"dispatch_ms": 3.0, "device_ms": None}]
    assert _read("wave_device_ms", waves) == pytest.approx(12.0)
    assert _read("wave_device_ms", [{"dispatch_ms": 50.0, "device_ms": None}]) is None
    assert _read("wave_device_ms", [{"dispatch_ms": 50.0}]) is None
    assert _read("wave_device_ms", []) is None


def test_admit_wait_p95_spans_every_clip_of_every_wave():
    waves = [{"admit_wait_ms": [10.0, 12.0]}, {"admit_wait_ms": list(range(100, 118))},
             {"dispatch_ms": 1.0}]
    every = [10.0, 12.0] + list(range(100, 118))
    assert _read("admit_wait_ms.p95", waves) == pytest.approx(np.percentile(every, 95))
    assert _read("admit_wait_ms.p95", [{"dispatch_ms": 1.0}]) is None
