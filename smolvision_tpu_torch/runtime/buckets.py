"""Shape bucketing (port of smolvision_tpu/runtime/buckets.py).

The port keeps the JAX package's buckets so both run the same padded
shapes (and so the same pad rows) on the same input.

Recompile avoidance is the central constraint the C engine never had: mel
frames, encoder token counts, prefill lengths and KV sizes all vary per
input, so every device entry point gets padded pow2 buckets with explicit
length masks (SURVEY.md §7 design stance; mirrors the reference's own
next_pow2 KV headroom arithmetic, README.md:479-481).
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket(n: int, minimum: int = 16) -> int:
    """Smallest pow2 >= max(n, minimum)."""
    return max(next_pow2(n), minimum)


def window_bucket(n_tokens: int, window_tokens: int, min_windows: int = 1) -> int:
    """Encoder token cap: pow2 number of attention windows."""
    n_windows = max((n_tokens + window_tokens - 1) // window_tokens, min_windows)
    return next_pow2(n_windows) * window_tokens


def bucket64(n: int, minimum: int = 64) -> int:
    """Round up to a multiple of 64 (the batched prompt and KV caps: capacity
    scales every batched decode step's KV read, so it grows in 64-row steps
    instead of pow2 jumps)."""
    return max((n + 63) // 64 * 64, minimum)


def bucket128(n: int, minimum: int = 128) -> int:
    """Round up to a multiple of 128 (multistream's prompt cap)."""
    return max((n + 127) // 128 * 128, minimum)
