"""Fused lm_head matvec + argmax (kernels K6 and K7): CUDA wrapper and plain version.

Port of the Pallas probes of the greedy decode head:

  * `pallas_argmax_matvec` (tools/profile_decode2.py) and `mv_argmax`
    (tools/profile_decode3.py), bf16 weights         -> K6
  * `mv_q8_argmax` (tools/probe_int8.py), int8 weights with per-row f32
    scales                                            -> K7
  both in csrc/argmax_matvec.cu, which also has an f32 instantiation for
  the --f32 engine's head (counted with K6).

`argmax_matvec(h, w, scale)` returns int32 [R]: for each row of h [R, H]
the first index v < V maximising (c(h_r) . w[v]) * scale[v], with f32
accumulation; c rounds to bf16 unless w is f32 (the port's `linear` casts
activations to the weight dtype).  The weights are the model's [V, H]
table as it is, without the TPU probes' padding to a block multiple.  CPU
tensors take the plain version, which computes the [R, V] logits and
`torch.argmax` (first index on ties).  CUDA tensors take one of the
kernel's two routes, which `head_route` picks from R and the table's type:

  * "cuda_core": the CUDA-core matvec, for R <= HEAD_TC_ABOVE[dtype] and
    for every f32 table; any R in one launch (rows of h that do not fit in one
    block's shared memory together, more than 55 at H 1024, are taken in
    passes that each read the table again);
  * "tensor_core": a bf16 mma.sync tile product fused with the argmax, for
    bf16 and int8 tables above HEAD_TC_ABOVE[dtype] rows; the table is read once
    per call for R up to 256.

Under a vocabulary-sharded head (parallel/mesh.py: each rank holds rows
[offset, offset + V) of the table) the wrapper returns, with `offset`, the
kernel's 64-bit keys instead of indices: the order-preserving value bits
above ~(offset + index), with bit 63 flipped so that torch's signed int64
orders them as the kernel's unsigned keys (`pack_keys`, which the plain
version uses).  Their maximum over the ranks is the largest value and,
among equal values, the lowest global index -- the single-device argmax;
`key_index` takes the index back out.

Each launch adds one to `launch_counts[launch_key(route, dtype)]`:
"argmax_matvec" / "argmax_matvec_tc" (bf16, f32) and "argmax_matvec_q8" /
"argmax_matvec_q8_tc" (int8).  There is no fallback: a route the wrapper
cannot take raises.
"""

from __future__ import annotations

import torch

from smolvision_tpu_torch.kernels import ffi

# The crossover R* per table type: the largest R at which the CUDA-core
# matvec is still at least as fast as the tensor-core route.  From the sweep
# of R in chip_smoke.py (head_sweep) on an NVIDIA H100 80GB HBM3, 700 W
# power limit, at the 0.6B head [151936, 1024]; PERF.md gives the sweep
# (between R 2 and 5 the two bf16 routes are within 4% of each other).
HEAD_TC_ABOVE = {torch.bfloat16: 4, torch.int8: 2}

_W_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
_SIGNATURES = {"cuda_core": ("sv_argmax_matvec", "pppppiiiip"),
               "tensor_core": ("sv_argmax_matvec_tc", "ppppppiiiip")}


def head_route(R: int, dtype: torch.dtype) -> str:
    """The route a head over R rows of h and a `dtype` table takes on the
    card: "tensor_core" for bf16 / int8 above HEAD_TC_ABOVE[dtype] rows,
    else "cuda_core"."""
    if R < 1:
        raise ValueError(f"a head needs at least one row of h, got {R}")
    if dtype not in _W_KIND:
        raise ValueError(f"lm_head must be bf16, f32 or int8, got {dtype}")
    if dtype in HEAD_TC_ABOVE and R > HEAD_TC_ABOVE[dtype]:
        return "tensor_core"
    return "cuda_core"


def launch_key(route: str, dtype: torch.dtype) -> str:
    """The `ffi.launch_counts` key of one launch of `route` on a `dtype` table."""
    return (("argmax_matvec_q8" if dtype == torch.int8 else "argmax_matvec")
            + ("_tc" if route == "tensor_core" else ""))


def logits_plain(h: torch.Tensor, w: torch.Tensor, scale=None) -> torch.Tensor:
    """The [R, V] f32 logits the kernel never materialises."""
    if w.dtype == torch.float32:
        y = h.float() @ w.t()
    else:
        hb = h.to(torch.bfloat16)
        wb = w.to(torch.bfloat16)  # int8 -> bf16 is exact
        if h.is_cuda:
            y = torch.mm(hb, wb.t(), out_dtype=torch.float32)
        else:  # the CPU build has no bf16 -> f32 product; widening is exact
            y = hb.float() @ wb.float().t()
    return y if scale is None else y * scale


_LOW = 0xFFFFFFFF
_HIGH = -(1 << 32)               # ~_LOW as int64: the value half of a key
_BIT63 = -(1 << 63)              # flips unsigned key order into signed order


def pack_keys(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys, signed-ordered, of f32 values and int64 indices: the
    kernel's packing (argmax_matvec.cu `pack`: -0 folded into +0, the
    order-preserving value bits, then ~index) with bit 63 flipped."""
    bits = torch.where(values == 0, torch.zeros_like(values), values).contiguous()
    bits = bits.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    return ordered * (1 << 32) + ((~index.long()) & _LOW)


def key_index(keys: torch.Tensor) -> torch.Tensor:
    """The index packed into keys (pack_keys): int32."""
    return ((~keys) & _LOW).to(torch.int32)


def argmax_matvec_plain(h: torch.Tensor, w: torch.Tensor, scale=None,
                        offset=None) -> torch.Tensor:
    logits = logits_plain(h, w, scale)
    idx = torch.argmax(logits, dim=-1)
    if offset is None:
        return idx.to(torch.int32)
    return pack_keys(logits.gather(1, idx[:, None])[:, 0], idx + offset)


def argmax_matvec(h: torch.Tensor, w: torch.Tensor, scale=None, route=None,
                  offset=None) -> torch.Tensor:
    """Greedy head over h [R, H] f32 and w [V, H] (bf16 / f32, or int8 with
    scale [V] f32): int32 [R] (kernel K6 / K7 on CUDA).  `route` forces a
    route on the card (the crossover sweep times both); by default
    `head_route` picks it.  With `offset` (w's first row in the whole
    vocabulary): the keys of the rows' maxima, int64 [R] (see the module
    notes)."""
    if not h.is_cuda:
        return argmax_matvec_plain(h, w, scale, offset)
    R, H = h.shape
    V = w.shape[0]
    q8 = w.dtype == torch.int8
    route = route or head_route(R, w.dtype)
    ffi.require(route in _SIGNATURES, f"unknown head route {route!r}")
    ffi.require(w.dtype in _W_KIND, f"lm_head must be bf16, f32 or int8, got {w.dtype}")
    ffi.require(q8 == (scale is not None), "int8 weights need their scales, and only they")
    tensors = (h, w) + ((scale,) if q8 else ())
    ffi.check_cuda(*tensors)
    ffi.require(h.dtype == torch.float32 and h.dim() == 2, "h must be f32 [R, H]")
    ffi.require(w.dim() == 2 and w.shape[1] == H, "w must be [V, H]")
    ffi.require(all(t.is_contiguous() for t in tensors), "operands must be contiguous")
    ffi.require(h.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                "h and w must start on a 16-byte boundary")
    ffi.require(not q8 or (scale.dtype == torch.float32 and scale.shape == (V,)),
                "scale must be f32 [V]")
    ffi.require(R >= 1, "h has no rows")
    keys = torch.empty((R,), dtype=torch.int64, device=h.device)
    out = torch.empty((R,), dtype=torch.int32, device=h.device)
    symbol, signature = _SIGNATURES[route]
    common = (keys.data_ptr(), out.data_ptr(), R, H, V, _W_KIND[w.dtype], ffi.stream())
    scale_ptr = scale.data_ptr() if q8 else None
    if route == "tensor_core":
        ffi.require(w.dtype != torch.float32,
                    "an f32 lm_head has no tensor-core route (it keeps its f32 products)")
        ffi.require(H % 128 == 0, f"hidden size {H} is not a multiple of 128")
        hb = torch.empty((R, H), dtype=torch.bfloat16, device=h.device)
        ffi.call("argmax_matvec", symbol, signature, h.data_ptr(), w.data_ptr(), scale_ptr,
                 hb.data_ptr(), *common)
    else:
        chunk = 32 * 16 // w.element_size()  # 32 lanes x one 16-byte load of weights
        ffi.require(H % chunk == 0, f"hidden size {H} is not a multiple of {chunk} for {w.dtype}")
        ffi.call("argmax_matvec", symbol, signature, h.data_ptr(), w.data_ptr(), scale_ptr,
                 *common)
    ffi.launch_counts[launch_key(route, w.dtype)] += 1
    if offset is None:
        return out
    return ((keys ^ _BIT63) & _HIGH) | ((~(out.long() + offset)) & _LOW)
