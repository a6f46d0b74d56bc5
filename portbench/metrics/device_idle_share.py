"""Share of the device window (portbench/devtrace.py: CUDA activity alone)
in which no operation ran on the device: the union of the profiler's
device events against the window's host-clock length."""


def read(run):
    if not run.trace or run.trace["busy_s"] <= 0 or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
