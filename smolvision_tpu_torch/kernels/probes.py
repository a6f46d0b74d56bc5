"""The measurement probes (kernels K8 and K9): CUDA wrappers and plain versions.

  * `read_all(x, s)` = max(f32(x)) + s over a bf16 table: port of
    `read_all` (tools/profile_decode3.py), the read-bandwidth roofline that
    chip_smoke.py runs over the lm_head beside the greedy-head kernels.
  * `probe_mm(x, y)` = x @ y in f32: port of `pallas_mm`
    (tools/probe_compile_cache.py).  There it probed JAX's persistent
    compile cache; chip_smoke.py launches it from a library that a fresh
    process loads from kernels/build.py's source-hash cache, without nvcc.

Both live in csrc/probes.cu.  CUDA tensors run the kernel and add one to
`launch_counts["read_all"]` / `["probe_mm"]`; CPU tensors take the plain
version.  There is no fallback.
"""

from __future__ import annotations

import torch

from smolvision_tpu_torch.kernels import ffi

_READ_SIGNATURE = "plfppp"
_MM_SIGNATURE = "pppiiip"


def read_all_plain(x: torch.Tensor, s: float) -> torch.Tensor:
    return (x.float().max() + s).reshape(())


def read_all(x: torch.Tensor, s: float) -> torch.Tensor:
    """max(f32(x)) + s as a 0-dim f32 tensor (kernel K8 on CUDA)."""
    if not x.is_cuda:
        return read_all_plain(x, s)
    ffi.check_cuda(x)
    ffi.require(x.dtype == torch.bfloat16 and x.is_contiguous() and x.numel() > 0
                and x.data_ptr() % 16 == 0,
                "x must be a non-empty contiguous bf16 tensor on a 16-byte boundary")
    key = torch.empty((1,), dtype=torch.int32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    ffi.call("probes", "sv_read_all", _READ_SIGNATURE, x.data_ptr(), x.numel(), float(s),
             key.data_ptr(), out.data_ptr(), ffi.stream())
    ffi.launch_counts["read_all"] += 1
    return out


def probe_mm_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.float() @ y.float()


def probe_mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ y [K, N] in f32 (kernel K9 on CUDA: register-tiled f32
    FMA, 16 x 32 output tiles, k tiles through a two-stage cp.async ring;
    any M, N, K)."""
    if not x.is_cuda:
        return probe_mm_plain(x, y)
    ffi.check_cuda(x, y)
    ffi.require(x.dtype == y.dtype == torch.float32 and x.is_contiguous() and y.is_contiguous(),
                "x and y must be contiguous f32")
    ffi.require(x.dim() == y.dim() == 2 and x.shape[1] == y.shape[0], "shapes disagree")
    M, K = x.shape
    N = y.shape[1]
    ffi.require(M > 0 and N > 0, "empty product")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ffi.call("probes", "sv_probe_mm", _MM_SIGNATURE, x.data_ptr(), y.data_ptr(), out.data_ptr(),
             M, N, K, ffi.stream())
    ffi.launch_counts["probe_mm"] += 1
    return out
