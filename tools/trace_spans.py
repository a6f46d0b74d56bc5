"""A traced run of one cell with the program's spans read out.

    python3 tools/trace_spans.py --workload <name> --seed <n> --seconds <s>
                                 [--ranges 0|1] [--host-calls N]

A measurement script beside the benchmark, not part of it:
portbench/run.py's --trace 1 run with three additions, made at run time
here and nowhere in the files run.py uses (a change to those is a
benchmark change of its own, PERF.md section 7):

* the span counters of smolvision_tpu_torch/runtime/perf.py
  (`SPAN_SUMS`) summed over the untraced window beside `PERF_SUMS`, and
  the span metrics computed from them (`span_metrics` in the line);
* the program's `smolvision.*` ranges on in the host window (--ranges 1),
  whose device-side mirrors are dropped from the trace's device events, so
  an idle gap is named by the program's span the host was in;
* the host window N calls long, each call's rate in `host_rates`.

Its result line is run.py's with `span_metrics`, `span_sums` and
`host_rates` added.  It needs a program with runtime/perf.py, and it
replaces harness names for its run (harness.PERF_SUMS,
harness.free_engine, devtrace._events, run.drive), so a rename there
breaks it.
"""

from __future__ import annotations

import argparse
import os
import sys

# the checkout's root, where run.py's imports start too
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import devtrace, harness, traffic  # noqa: E402
from portbench import run as run_mod  # noqa: E402

SPAN_SUMS = ("encode_device_ms", "batch_decode_device_ms", "decode_device_ms", "capture_ms",
             "captures", "host_wait_ms")


def span_metrics(run) -> dict:
    """The seven span metrics of the untraced window (None where there is
    nothing to read)."""
    t = run.totals.perf

    def per(x, y):
        return float(x / y) if x and y else None

    waves = run.totals.serving_waves
    dev = [w["device_ms"] for w in waves if w.get("device_ms") is not None]
    admit = [x for w in waves for x in w.get("admit_wait_ms", ())]
    return {
        "encode_device_ms_per_audio_s": per(t["encode_device_ms"], run.audio_s),
        "wave_device_ms": float(np.mean(dev)) if dev else None,
        "batch_step_device_ms": per(t["batch_decode_device_ms"], t["batch_decode_steps"]),
        "decode_step_device_ms.stream": per(t["decode_device_ms"], t["decode_steps"]),
        "capture_ms_per_call": per(t["capture_ms"], len(run.records)),
        "host_wait_share": per(100.0 * t["host_wait_ms"], 1000.0 * run.window_s),
        "admit_wait_ms.p95": float(np.percentile(admit, 95)) if admit else None,
    }


def run_spans(args, ranges: bool = True, host_calls: int = 3, **cell) -> dict:
    """run.run_cell(args, **cell) with the additions of the module
    docstring; the result object."""
    from smolvision_tpu_torch.runtime.perf import profile_ranges

    host_rates: list = []
    kept: dict = {}
    saved = (harness.PERF_SUMS, devtrace._events, run_mod.drive, harness.free_engine)
    events, drive, free = saved[1:]

    def program_events(prof):
        dev, host = events(prof)
        return [d for d in dev if not d[2].startswith("smolvision.")], host

    def host_drive(run, seconds):
        if seconds > 0:
            return drive(run, seconds)
        was = profile_ranges(ranges)
        recs, total = [], 0.0
        try:
            for _ in range(host_calls):
                r, secs = drive(run, 0.0)
                audio = sum(len(c) for x in r for c in x["clips"]) / traffic.SAMPLE_RATE
                host_rates.append(audio / secs)
                recs += r
                total += secs
        finally:
            profile_ranges(was)
        return recs, total

    def keep(run):
        kept["run"] = run
        free(run)

    harness.PERF_SUMS = saved[0] + SPAN_SUMS
    devtrace._events, run_mod.drive, harness.free_engine = program_events, host_drive, keep
    args.trace = 1
    try:
        out = run_mod.run_cell(args, **cell)
    finally:
        harness.PERF_SUMS, devtrace._events, run_mod.drive, harness.free_engine = saved
    run = kept["run"]
    out["span_metrics"] = span_metrics(run)
    out["span_sums"] = {k: run.totals.perf[k] for k in SPAN_SUMS}
    out["host_rates"] = host_rates
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--ranges", type=int, choices=(0, 1), default=1)
    p.add_argument("--host-calls", type=int, default=3)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: trace_spans needs a CUDA device", file=sys.stderr)
        return 2
    args = argparse.Namespace(workload=a.workload, seed=a.seed, seconds=a.seconds, trace=1)
    return run_mod.finish(run_spans(args, bool(a.ranges), a.host_calls))


if __name__ == "__main__":
    sys.exit(main())
