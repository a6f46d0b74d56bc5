"""The decoder prefill's ms (PerfStats.prefill_ms) per second of audio
completed."""


def read(run):
    ms = run.totals.perf["prefill_ms"]
    return ms / run.audio_s if ms > 0 and run.audio_s > 0 else None
