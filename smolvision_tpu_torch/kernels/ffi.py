"""ctypes glue shared by the kernel wrappers, and every kernel's launch count.

Each wrapper (kernels/flash_attention.py, argmax_matvec.py, probes.py)
binds its C symbol from the library `build.load` gives, calls it on
PyTorch's current stream, raises if the C function returns a CUDA error,
and adds one to `launch_counts[name]` per launch.  The counts of all nine
kernels (the greedy head under one key per route and weight type) live in
this one dictionary, so one `reset_launch_counts()` sets every count to 0
before a path runs.  A CUDA-graph replay runs no wrapper: the decode loop
(runtime/decode_graph.StepGraph) adds the launches its capture recorded,
once per replay, and takes back those the capture itself counted.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

# a C function's argument types, one letter each: pointer, int, long long, float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong, "f": ctypes.c_float}

launch_counts: Dict[str, int] = {
    "window_attention": 0,
    "causal_cache_attention": 0,
    "decode_attention": 0,
    "batched_causal_attention": 0,
    "batched_cache_attention": 0,
    "argmax_matvec": 0,        # bf16 and f32 lm_head weights, CUDA-core route
    "argmax_matvec_tc": 0,     # bf16 lm_head weights, tensor-core route
    "argmax_matvec_q8": 0,     # int8 lm_head weights + per-row scales, CUDA-core route
    "argmax_matvec_q8_tc": 0,  # int8 lm_head weights + per-row scales, tensor-core route
    "read_all": 0,
    "probe_mm": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@functools.lru_cache(maxsize=None)
def _cfn(lib_name: str, symbol: str, signature: str):
    from smolvision_tpu_torch.kernels import build

    fn = getattr(build.load(lib_name), symbol)
    fn.argtypes = [_CTYPES[c] for c in signature]
    fn.restype = ctypes.c_int
    return fn


def call(lib_name: str, symbol: str, signature: str, *args) -> None:
    """Call `symbol` of library `lib_name`, whose argument types `signature`
    spells with the letters of `_CTYPES`; raise on a non-zero CUDA error."""
    rc = _cfn(lib_name, symbol, signature)(*args)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    require(all(t.is_cuda and t.device == dev for t in tensors),
            "all operands must be CUDA tensors on one device")
