"""Mean host ms of an admission wave's dispatch (the program's
PerfStats.serving_waves records) over the window's waves."""


def read(run):
    waves = run.totals.serving_waves
    return sum(w["dispatch_ms"] for w in waves) / len(waves) if waves else None
