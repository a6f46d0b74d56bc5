"""The 95th percentile (numpy's linear interpolation) over every chunk of
every stream in the window of the time from the program taking a chunk's
audio (a live-source wait_for that advances) to its taking the next; the
call's return closes a stream's last chunk."""

import numpy as np


def read(run):
    ms = run.totals.chunk_ms
    return float(np.percentile(ms, 95)) if ms else None
