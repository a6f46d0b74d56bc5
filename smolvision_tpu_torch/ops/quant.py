"""int8 decoder weights (--q8) and the int8 batched KV cache (--kv8).

Port of smolvision_tpu/ops/quant.py.  The field names stay `q` / `s`, so
each leaf has the same name as its counterpart in the JAX package.

  * `QuantW(q, s)`: int8 weights `q` laid out like the weight they replace
    ([..., O, H], contraction axis last) and f32 per-output-channel scales
    `s` ([..., O]).  Symmetric round-to-nearest-even over the contraction
    axis: s = max|w| / 127, q = round(w / s).
  * `proj(x, w)`: x [..., H] @ w^T with the scale folded into the f32
    output.  Under ACTQ_MIN_M collapsed rows (every decode step, and
    prefill blocks below 1024 rows) the int8 values are widened to bf16 and
    multiplied with bf16(x) in f32 accumulation; the JAX package leaves
    that product to XLA, here it is a plain cuBLAS product of the widened
    weight.  From ACTQ_MIN_M rows on, the activations are quantized per row
    too and the product is int8 x int8 with int32 accumulation
    (`torch._int_mm`), as the JAX package does for its dense GEMMs.
  * `QuantKV(q, s)`: the int8 batched cache [..., K, D] with one f32 scale
    per cache row [..., K].  Every cache operation the runtime performs
    indexes axes before D, so it applies to both leaves, the index tuple
    cut short for `s`.  Writes are in-place slice writes into both leaves.

The JAX package's A/B switches SMOLVISION_Q8_ACTQ / SMOLVISION_Q8_ACTQ_MIN
are not ported: the port runs their defaults (int8 x int8 on, from 1024
rows).  In the dense decoder every `proj` equation of the JAX package's
int8 x int8 sets reduces to "collapsed rows >= 1024"; its lm_head of one
row ("h,vh->v") and the --spec verify ("th,vh->tv") are outside those
sets, and neither reaches 1024 rows, so one rule covers every site.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from smolvision_tpu_torch.device import resolve_device

ACTQ_MIN_M = 1024


class QuantW(NamedTuple):
    """int8 weight + f32 per-output-channel scale.

    q: int8 [..., O, H] (same layout as the weight it replaces)
    s: f32  [..., O]    (scale of each output channel / row)
    """

    q: torch.Tensor
    s: torch.Tensor

    @property
    def dtype(self):  # the cast target of the activations
        return torch.bfloat16

    @property
    def shape(self):
        return self.q.shape


def _quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 over the last axis: (q int8, s f32)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def quantize_weight(w: torch.Tensor) -> QuantW:
    """Symmetric per-output-channel int8 over the last axis (contraction)."""
    return QuantW(*_quantize_rows(w))


def take(w, i):
    """Index the leading (layer) axis of a weight that may be quantized."""
    if isinstance(w, QuantW):
        return QuantW(w.q[i], w.s[i])
    return w[i]


def proj(x: torch.Tensor, w: QuantW) -> torch.Tensor:
    """x [..., H] @ w.q[O, H]^T * w.s -> f32 [..., O] (see the module notes)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    if x2.shape[0] >= ACTQ_MIN_M and w.q.dim() == 2:
        xq, xs = _quantize_rows(x2)
        acc = torch._int_mm(xq, w.q.t())
        y = acc.float() * xs[:, None] * w.s[None, :]
    else:
        wb = w.q.to(torch.bfloat16)  # exact: |q| <= 127
        if x2.is_cuda:
            y = torch.mm(x2, wb.t(), out_dtype=torch.float32)
        else:  # the CPU build has no bf16 -> f32 product; widening is exact
            y = x2.float() @ wb.float().t()
        y = y * w.s
    return y.reshape(*lead, w.q.shape[0])


def embed_rows(emb, ids: torch.Tensor) -> torch.Tensor:
    """Embedding-table gather -> f32 rows; the table may be a QuantW."""
    if isinstance(emb, QuantW):
        return emb.q[ids].float() * emb.s[ids][..., None]
    return emb[ids].float()


# ---------------------------------------------------------------------------
# int8 KV cache (--kv8), batched paths only.  The attention reads the rows
# widened to f32 with their scales (kv_read, models/qwen3_decoder).
# ---------------------------------------------------------------------------


class QuantKV(NamedTuple):
    """int8 KV cache + per-row f32 scales.

    q: int8 [..., K, D]
    s: f32  [..., K]     (scale of each cache row over D)
    """

    q: torch.Tensor
    s: torch.Tensor

    @property
    def dtype(self):
        return torch.int8

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device

    def __getitem__(self, idx):
        """Basic indexing on the shared leading axes (ints / slices), e.g.
        kv[layer, 0] for one layer's K cache: views of both leaves."""
        return QuantKV(self.q[idx], self.s[idx])


def quantize_kv_rows(x: torch.Tensor) -> QuantKV:
    """Symmetric per-row int8 over the last axis: x [..., D] -> QuantKV."""
    return QuantKV(*_quantize_rows(x))


def kv_zeros(shape: Sequence[int], dtype, device=None):
    """Allocate a KV cache on `device` (the card unless the caller names the
    CPU); dtype int8 selects the quantized layout."""
    device = resolve_device(device)
    if dtype == torch.int8:
        return QuantKV(torch.zeros(tuple(shape), dtype=torch.int8, device=device),
                       torch.zeros(tuple(shape[:-1]), dtype=torch.float32, device=device))
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def kv_read(cache: QuantKV, end=None) -> torch.Tensor:
    """Rows [0, end) of one int8 cache [B, KH, K, D] as f32 q * s; every row
    with end None (the decode step at a device position reads them all,
    under its mask)."""
    q, s = (cache.q, cache.s) if end is None else (cache.q[:, :, :end], cache.s[:, :, :end])
    return q.float() * s[..., None]


def kv_write(cache, start, rows: torch.Tensor) -> None:
    """In place: cache [B, KH, K, D] rows [start, start + T) <- rows
    [B, KH, T, D] (f32), quantized per row into a QuantKV cache (the slice
    write of the JAX package's kv_dus).  start is a host int, or an int64
    device tensor [T] of the rows' indices (the decode step's device
    position: an index_copy_, which a CUDA graph holds)."""
    T = rows.shape[2]
    if isinstance(start, torch.Tensor):
        leaves = zip(cache, quantize_kv_rows(rows)) if isinstance(cache, QuantKV) else \
            [(cache, rows.to(cache.dtype))]
        for leaf, new in leaves:
            leaf.index_copy_(2, start, new)
    elif isinstance(cache, QuantKV):
        new = quantize_kv_rows(rows)
        cache.q[:, :, start : start + T] = new.q
        cache.s[:, :, start : start + T] = new.s
    else:
        cache[:, :, start : start + T] = rows.to(cache.dtype)


def kv_rows_gather(kv, rows: Sequence[int], axis: int = 2):
    """A new cache holding batch rows `rows` (static indices, repeats
    allowed) of `kv` along `axis`, both leaves of a QuantKV: one block copy
    per row into fresh storage, never a gather index and never a view of
    `kv` (a decode graph captured on `kv` may still write into it)."""
    def gather(t):
        out = t.new_empty(t.shape[:axis] + (len(rows),) + t.shape[axis + 1:])
        for i, r in enumerate(rows):
            out.select(axis, i).copy_(t.select(axis, int(r)))
        return out

    if isinstance(kv, QuantKV):
        return QuantKV(gather(kv.q), gather(kv.s))
    return gather(kv)


def kv_grow_k(kv, kcap_new: int, k_axis: int = 4):
    """Zero-grow the K (cache position) axis to kcap_new."""
    def grow(t):
        new = t.new_zeros(t.shape[:k_axis] + (kcap_new,) + t.shape[k_axis + 1:])
        new[(slice(None),) * k_axis + (slice(0, t.shape[k_axis]),)] = t
        return new

    if isinstance(kv, QuantKV):
        return QuantKV(grow(kv.q), grow(kv.s))
    return grow(kv)
