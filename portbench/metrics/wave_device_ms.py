"""Mean device ms of an admission wave over the window's waves: the
program's PerfStats.serving_waves records' device_ms, the CUDA events on
the current stream around the wave's build and group prefill (the device's
idle time while the host dispatches an eager wave included), settled at
the call's end.  None where no wave carries it (the CPU; a program without
the span)."""


def read(run):
    ms = [w["device_ms"] for w in run.totals.serving_waves if w.get("device_ms") is not None]
    return sum(ms) / len(ms) if ms else None
