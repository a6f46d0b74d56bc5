"""The front end's ms (PerfStats.mel_ms, the device log-mel's CUDA events
once settled) per second of audio completed in the window."""


def read(run):
    ms = run.totals.perf["mel_ms"]
    return ms / run.audio_s if ms > 0 and run.audio_s > 0 else None
