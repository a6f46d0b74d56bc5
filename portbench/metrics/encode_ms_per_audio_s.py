"""The encode stage's ms (PerfStats.encode_ms: front end and encoder,
synchronised at the stage's end) per second of audio completed."""


def read(run):
    ms = run.totals.perf["encode_ms"]
    return ms / run.audio_s if ms > 0 and run.audio_s > 0 else None
