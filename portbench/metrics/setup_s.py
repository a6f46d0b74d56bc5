"""Set-up seconds: from the process's start (before torch is imported) to
the window's: imports, the card's start, the weights drawn on the device
and loaded, the kernels built or found built, and the cell's shapes warmed
up."""


def read(run):
    return run.setup_s
