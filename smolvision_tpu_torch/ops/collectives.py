"""The few collectives of the mesh paths, on torch.distributed.

Plain helpers over a process group, with no knowledge of the mesh
(parallel/mesh.py builds the groups).  Every helper takes the group of one
mesh axis, and None for an axis of size 1, where it does nothing: the
decoder and the schedulers call them unconditionally.  The f32 partials and
the packed head keys reduce in place; gathers return new tensors on the
input's device.  A `gloo` group stages through the host (ranks that share
one card), an `nccl` group works on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from smolvision_tpu_torch.ops.quant import QuantKV


def _on_backend(t: torch.Tensor, group) -> torch.Tensor:
    """Where `group`'s backend works: the CPU for gloo (ranks that share a
    card stage through the host), the card for nccl."""
    if dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        t = _on_backend(x, group)
        dist.all_reduce(t, op=op, group=group)
        if t is not x:
            x.copy_(t)
    return x


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over `group` in place (no-op for None); x is f32."""
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of x over `group` in place (no-op for None)."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The concatenation along `dim` of every rank's `t` over `group` (equal
    shapes), on t's device; t itself for None."""
    if group is None:
        return t
    src = _on_backend(t.contiguous(), group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_rows(kv, group):
    """A batched cache [L, 2, B, ...] with every rank's batch rows over
    `group` (both leaves of a QuantKV)."""
    if isinstance(kv, QuantKV):
        return QuantKV(all_gather_cat(kv.q, group, dim=2), all_gather_cat(kv.s, group, dim=2))
    return all_gather_cat(kv, group, dim=2)


def gather_host(values: np.ndarray, group, device=None) -> np.ndarray:
    """Every rank's host array over `group`, stacked [ranks, ...] (one
    all_gather); [1, ...] for None."""
    if group is None:
        return values[None]
    t = torch.from_numpy(np.ascontiguousarray(values))[None].to(device)
    return all_gather_cat(t, group).cpu().numpy()


def group_size(group) -> int:
    """The ranks of `group` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in `group` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)
