"""The window's needed operations (portbench/costs.py, counted from the
requests completed in the untraced window: encoder, prefill, decode, head)
over the window's seconds times 989 TFLOP/s (H100 bf16)."""

from portbench import costs


def read(run):
    if run.window_s <= 0 or run.flops <= 0:
        return None
    return 100.0 * run.flops / (run.window_s * costs.PEAK_BF16_FLOPS)
