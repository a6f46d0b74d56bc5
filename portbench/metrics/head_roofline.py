"""Share of its read bound that the greedy head (kernel K6,
kernels/argmax_matvec.py) reaches in the device window: its calls
(ffi.launch_counts, graph replays included) times the bf16 table's bytes
over 3.35 TB/s, against the device time of its kernels by name."""

from portbench import costs


def read(run):
    if not run.trace:
        return None
    calls = run.launches.get("argmax_matvec", 0) + run.launches.get("argmax_matvec_tc", 0)
    busy = sum(s for n, s in run.trace["by_name"].items() if "argmax" in n or "round_bf16" in n)
    if not calls or busy <= 0:
        return None
    return 100.0 * calls * costs.head_bytes(run.conf["model"]["text"]) \
        / costs.PEAK_BYTES_PER_S / busy
