"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a host with the card(s) the cell asks for.
The run makes its weights and requests from --seed, warms up its cell's
shapes, drives one entry of `smolvision_tpu_torch` in a closed loop for
--seconds, checks a sample of what it served against the plain reference,
and prints one JSON line last on standard output: the cell's end-to-end
metrics (--trace 0) or its per-layer metrics (--trace 1).  The window is
untraced either way.  With --trace 1 two traced windows follow it
(portbench/devtrace.py): the device window, calls past TRACE_SECONDS
under CUDA activity alone, gives the device's busy time and time by
kernel; the host window, one call under CPU and CUDA activity, names the
idle gaps.  Every other per-layer metric reads the untraced window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel caches of the program and of any library it loads live in the
# checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", "cache", sub)
# one process with one thread of each host pool: the host's other work
# does not crowd the window's own
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the checkout's root, not this directory, is where imports start (its
# modules are the `portbench` package's)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

from portbench import check, costs, harness, traffic  # noqa: E402
from portbench import devtrace as trace_mod  # noqa: E402

TRACE_SECONDS = 8.0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def drive(run, seconds: float):
    """Calls of the entry in a closed loop, on through the pool, until one
    ends past `seconds`: (their records, the window's seconds)."""
    import torch

    records = []
    t0 = harness.now()
    while True:
        req = run.pool[run.sent % len(run.pool)]
        run.sent += 1
        with torch.profiler.record_function(f"portbench.{run.mix['entry']}.call"):
            records.append(run.call(req))
        if harness.now() - t0 >= seconds:
            return records, harness.now() - t0


def trace_windows(run, args) -> None:
    """After the untraced window, the device window (CUDA activity alone,
    TRACE_SECONDS) and the host window (CPU and CUDA activity, one call):
    the trace's readings into `run`, each window's audio seconds per
    second into `run.rates`.  Their counters stay out of the totals."""
    from smolvision_tpu_torch.kernels import ffi

    kept = run.totals
    rates = {"untraced": run.audio_s / run.window_s}

    def rate(recs, secs):
        return sum(len(c) for r in recs for c in r["clips"]) / traffic.SAMPLE_RATE / secs

    run.totals = harness.Totals()
    # each profiler's start (the card's tracing set up: seconds) stays out
    # of its window
    prof = trace_mod.profiler()
    prof.__enter__()
    ffi.reset_launch_counts()
    t0 = harness.now()
    recs, secs = drive(run, min(TRACE_SECONDS, args.seconds))
    run.launches = dict(ffi.launch_counts)
    prof.__exit__(None, None, None)
    run.trace = trace_mod.summarize(prof, t0, t0 + secs)
    rates["device_trace"] = rate(recs, secs)
    prof = trace_mod.profiler(host=True)
    prof.__enter__()
    recs, secs = drive(run, 0.0)
    prof.__exit__(None, None, None)
    run.trace["idle_gaps"] = trace_mod.idle_gaps(prof)
    rates["host_trace"] = rate(recs, secs)
    run.rates = rates
    run.totals = kept
    print("portbench: audio s/s by window: " + ", ".join(f"{k} {v:.4f}" for k, v in rates.items()),
          file=sys.stderr)


def run_cell(args, device: str = "cuda", t_start: float = T_START, conf=None,
             mix=None, control=None, cell=None, limits=None) -> dict:
    """The whole run on `device`; returns the result object (`finish`
    prints it).  `cell`, `conf`, `mix` and `limits` stand in for the cell's
    entry and files (the CPU rehearsals' tiny sizes); `control` ("int8")
    adds the control's reading of the same sample (portbench/control.py)."""
    import torch

    torch.set_num_threads(1)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = cell or harness.find_cell(bench, args.workload)
    conf = conf or harness.load_json(harness.HERE, "configs", cell["config"] + ".json")
    mix = mix or traffic.load_mix(cell["traffic"])
    run = harness.Run(cell=cell, conf=conf, mix=mix, seed=args.seed, device=device)
    run.entry = harness.load_module("entries", mix["entry"])
    run.limits = limits or check.limits(cell["name"])
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    run.engine = harness.build_engine(conf, args.seed, device)
    run.pool = traffic.requests(mix, args.seed)
    run.entry.prepare(run)
    run.entry.warmup(run)
    run.totals = harness.Totals()
    run.setup_s = harness.now() - t_start

    # the window: untraced, whatever --trace says; every metric but the
    # device trace's reads it
    records, run.window_s = drive(run, args.seconds)
    run.records = records
    run.audio_s = sum(len(c) for rec in records for c in rec["clips"]) / traffic.SAMPLE_RATE
    run.flops = sum(costs.request_flops(conf["model"], run.entry.work(run, rec))
                    for rec in records)
    if args.trace:
        trace_windows(run, args)
    run.memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    harness.free_engine(run)
    t_check = harness.now()
    correct, compared, got = check.judge(run, records, control)
    print(f"portbench: {args.workload} seed {args.seed}: set-up {run.setup_s:.1f} s, window "
          f"{run.window_s:.1f} s ({len(records)} calls), check {harness.now() - t_check:.1f} s",
          file=sys.stderr)

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = harness.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": bool(correct), "attempted": sum(len(r["answers"]) for r in records),
           "failed": sum(1 for r in records for a in r["answers"] if not a),
           "metrics": metrics, "device": dev}
    if run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, s in run.trace["device_ops"]],
                            "idle_gaps": [[n[:120], s] for n, s in run.trace["idle_gaps"]]}
        out["audio_s_per_s_by_window"] = run.rates
    out["check"] = got
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    chips = 1
    try:
        chips = harness.find_cell(harness.load_json(ROOT, "BENCHMARK.json"),
                                  args.workload).get("chips", 1)
    except (OSError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return finish(run_cell(args))


def finish(out: dict) -> int:
    """Print the result line and the numbers compared, unless the process
    has loaded JAX or the JAX package by now (the metric readers and the
    check included): then name them and print no result."""
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
