"""torch.cuda.max_memory_allocated() over set-up and window (after a reset
at the start), in GiB: read before the check runs."""


def read(run):
    return run.memory_peak / 2 ** 30 if run.memory_peak else None
