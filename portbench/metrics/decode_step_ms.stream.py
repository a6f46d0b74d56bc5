"""Wall ms of a single-stream decode step: (PerfStats.decode_ms - prefill_ms)
over decode_steps (decode_ms holds the prefill; the steps run, those past
a chunk's end included)."""


def read(run):
    p = run.totals.perf
    return (p["decode_ms"] - p["prefill_ms"]) / p["decode_steps"] if p["decode_steps"] else None
