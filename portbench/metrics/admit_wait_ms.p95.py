"""The 95th percentile (numpy's linear interpolation) over every clip of
the window's queues of the ms from the call's start to the clip's
admission into a decode slot with its first token read: the program's
PerfStats.serving_waves records' admit_wait_ms, one per clip.  None for a
program whose records lack it."""

import numpy as np


def read(run):
    ms = [x for w in run.totals.serving_waves for x in w.get("admit_wait_ms", ())]
    return float(np.percentile(ms, 95)) if ms else None
