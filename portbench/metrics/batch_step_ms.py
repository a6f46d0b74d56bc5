"""Wall ms of a batched decode step: PerfStats.batch_decode_ms over
batch_decode_steps (the steps run, those past a chunk's end included)."""


def read(run):
    p = run.totals.perf
    return p["batch_decode_ms"] / p["batch_decode_steps"] if p["batch_decode_steps"] else None
