"""Attention kernels: CUDA wrappers and their plain versions.

Port of the five Pallas kernels of smolvision_tpu/kernels/flash_attention.py:

  * `window_flash_attention`         (B1, encoder)  -> csrc/window_attention.cu
  * `causal_cache_flash_attention`   (B2, prefill)  -> csrc/causal_cache_attention.cu
  * `decode_flash_attention`         (B3, decode)   -> csrc/decode_attention.cu
  * `batched_causal_flash_attention` (B4, batched fresh prefill)
                                                    -> csrc/batched_causal_attention.cu
  * `batched_cache_flash_attention`  (B5, batched delta prefill)
                                                    -> csrc/batched_cache_attention.cu

Each wrapper launches its hand-written sm_90a kernel for CUDA tensors and
adds one to `ffi.launch_counts[name]` (kernels/ffi.py) per launch; for CPU
tensors it calls the plain torch version beside it (same contract: masks,
kv_min / start_pos semantics, zero output for a row with no key).  There
is no fallback: a CUDA tensor either goes through the kernel or the
wrapper raises.  `batched_decode_attention`, the batched decode step's
attention, has no kernel: the JAX package computes it outside any kernel.

All math is f32 with scale 1/sqrt(D) applied to q before the product.
Shapes keep the JAX package's layouts ([W, S, H, D] windows, [K, KH, D]
cache, [B, KH, K, D] batched cache) so the tests compare like with like.
"""

from __future__ import annotations

import math

import torch

from smolvision_tpu_torch.kernels import ffi

NEG_INF = -1e30
DENOM_FLOOR = 1e-30
# the decode kernel's fixed grid (B3): this many blocks (one thread block
# cluster) per KV head at every position, each taking ceil(live / 8) of
# the live rows, worked out in the kernel from the device position.  8, the
# portable cluster size (csrc/decode_attention.cu's kBlocks)
DECODE_MAX_BLOCKS = 8
# B1 (csrc/window_attention.cu): a window of up to WINDOW_BLOCK_ROWS rows is
# held whole by one block (or its rows by two, see `window_row_blocks`);
# longer windows take query tiles of WINDOW_TILE_ROWS rows.  WINDOW_ROW_BLOCKS
# forces the split of the first route (1 or 2; None: the plan picks), for
# chip_smoke.py's sweep
WINDOW_BLOCK_ROWS = 128
WINDOW_TILE_ROWS = 64
WINDOW_ROW_BLOCKS = None

# C argument types, one letter each (kernels/ffi.py)
_SIGNATURES = {
    "sv_window_attention": ("window_attention", "pppppiiiiifp"),
    "sv_causal_cache_attention": ("causal_cache_attention", "ppppiiiilppiifp"),
    "sv_decode_attention": ("decode_attention", "ppppppiiilppiifp"),
    "sv_batched_causal_attention": ("batched_causal_attention", "pppppiiiiifp"),
    "sv_batched_cache_attention": ("batched_cache_attention", "ppppppppipiiiiilllpifp"),
}


def _call(symbol: str, *args) -> None:
    lib_name, signature = _SIGNATURES[symbol]
    ffi.call(lib_name, symbol, signature, *args)


def _kv_flag(k_cache: torch.Tensor, v_cache: torch.Tensor) -> int:
    ffi.require(k_cache.dtype == v_cache.dtype
                and k_cache.dtype in (torch.bfloat16, torch.float32),
                f"cache must be bf16 or f32, got {k_cache.dtype}/{v_cache.dtype}")
    ffi.require(k_cache.shape == v_cache.shape and k_cache.stride() == v_cache.stride(),
                "k/v caches must share shape and strides")
    _, KH, D = k_cache.shape
    ffi.require(k_cache.stride(2) == 1 and k_cache.stride(1) == D,
                "cache rows must be [KH, D] contiguous")
    return int(k_cache.dtype == torch.bfloat16)


def _masked_probs(s, mask):
    """Softmax over the last axis in which masked entries are exactly 0, as
    in the Pallas kernels: NEG_INF before the max, a zero after the exp, and
    the 1e-30 floor under the sum (a row with no key gives all zeros)."""
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True) if s.shape[-1] else s[..., :1]
    p = torch.where(mask, torch.exp(s - m), 0.0)
    return p / torch.clamp(p.sum(-1, keepdim=True), min=DENOM_FLOOR)


# ---------------------------------------------------------------------------
# B1: encoder window attention
# ---------------------------------------------------------------------------

def window_attention_plain(q, k, v, kv_valid_lens):
    """q,k,v: [W, S, H, D]; kv_valid_lens: [W] int.  Returns [W, S, H, D] f32;
    keys >= kv_valid_lens[w] are masked, a window with no valid key gives 0,
    pad query rows attend the valid keys (finite garbage)."""
    W, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("wthd,wshd->whts", q.float() * scale, k.float())
    lens = kv_valid_lens.to(device=q.device, dtype=torch.int64)
    valid = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    return torch.einsum("whts,wshd->wthd", _masked_probs(s, valid), v.float())


def window_row_blocks(W: int, S: int, H: int, sms: int) -> int:
    """Blocks per (window, head) of kernel B1 on a card with `sms` SMs.
    Above WINDOW_BLOCK_ROWS rows: one per query tile of WINDOW_TILE_ROWS.
    Else 1 (the window whole in one block), or 2 (its 16-row warps split
    over two blocks, each loading the window's K/V) while the split grid of
    2 * W * H blocks still fits one wave of the SMs and a window has two
    warps' rows to split."""
    if S > WINDOW_BLOCK_ROWS:
        return -(-S // WINDOW_TILE_ROWS)
    if WINDOW_ROW_BLOCKS is not None:
        return WINDOW_ROW_BLOCKS
    return 2 if S > 16 and 2 * W * H <= sms else 1



def window_flash_attention(q, k, v, kv_valid_lens):
    """Bidirectional attention inside hard windows (kernel B1 on CUDA, on
    the tensor cores: three bf16 mma.sync per product on hi / lo splits of
    the f32 q, K, P and V; a window of up to WINDOW_BLOCK_ROWS rows resident
    in one block with one exact softmax, longer windows in query tiles)."""
    if not q.is_cuda:
        return window_attention_plain(q, k, v, kv_valid_lens)
    W, S, H, D = q.shape
    lens = kv_valid_lens.to(device=q.device, dtype=torch.int32).contiguous()
    ffi.check_cuda(q, k, v, lens)
    ffi.require(q.dtype == k.dtype == v.dtype == torch.float32, "q/k/v must be f32")
    ffi.require(k.shape == q.shape and v.shape == q.shape and lens.shape == (W,),
                "q/k/v must be [W, S, H, D] and kv_valid_lens [W]")
    ffi.require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
                "q/k/v must be contiguous")
    ffi.require(D == 64, f"head dim {D} not built (64)")
    ffi.require(q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
                "q/k/v rows must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    out = torch.empty_like(q)
    _call("sv_window_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
          lens.data_ptr(), out.data_ptr(), W, S, H, D, window_row_blocks(W, S, H, sms),
          1.0 / math.sqrt(D), ffi.stream())
    ffi.launch_counts["window_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B2: prefill causal attention against the cache
# ---------------------------------------------------------------------------

def causal_cache_attention_plain(q, k_cache, v_cache, start_pos, kv_valid_len, kv_min: int = 0):
    """q: [T, H, D] at cache rows start_pos + t; k/v_cache: [K, KH, D] already
    holding the block.  Column c is attended by row r iff kv_min <= c <= r and
    c < kv_valid_len.  Returns [T, H, D] f32.

    With host ints it reads only rows [kv_min, min(start_pos + T,
    kv_valid_len)).  With a device start (a one-element int tensor, as a
    prefill graph or the --spec verify keeps it; kv_valid_len an int or such
    a tensor) it is the fixed-shape form: every row of the [K] cache under a
    mask built from the tensors, with no host read."""
    T, H, D = q.shape
    KH = k_cache.shape[1]
    G = H // KH
    if isinstance(start_pos, torch.Tensor):
        lo, hi = 0, k_cache.shape[0]
        rows = start_pos.reshape(1) + torch.arange(T, device=q.device)
        valid = (kv_valid_len.reshape(1) if isinstance(kv_valid_len, torch.Tensor)
                 else kv_valid_len)
    else:
        lo = kv_min
        hi = max(min(start_pos + T, kv_valid_len), lo)
        rows = start_pos + torch.arange(T, device=q.device)
        valid = kv_valid_len
    kf = k_cache[lo:hi].float()
    vf = v_cache[lo:hi].float()
    qc = (q.float() * (1.0 / math.sqrt(D))).reshape(T, KH, G, D)
    s = torch.einsum("tkgd,skd->kgts", qc, kf)
    cols = lo + torch.arange(hi - lo, device=q.device)
    mask = (cols[None, :] <= rows[:, None]) & (cols[None, :] < valid) & (cols[None, :] >= kv_min)
    return torch.einsum("kgts,skd->tkgd", _masked_probs(s, mask), vf).reshape(T, H, D)


def causal_cache_flash_attention(q, k_cache, v_cache, start_pos, kv_valid_len, *,
                                 kv_min: int = 0):
    """Causal GQA attention of a query block against the cache (kernel B2 on
    CUDA).  The kernel reads start_pos and kv_valid_len from device memory:
    pass them as one-element int32 / int64 device tensors (a prefill graph's
    or the --spec verify's start, which a CUDA graph holds) or host ints
    (filled in on the device here, and checked against the cache; a device
    start is checked by its owner).  kv_min is a host int.

    On the tensor cores (csrc/mma_attention.cuh: bf16 mma.sync with f32
    accumulation on hi / lo splits; any G = H / KH up to 64): two products
    on a bf16 cache (q and P split), three on an f32 cache (its K and V
    split too)."""
    if not q.is_cuda:
        return causal_cache_attention_plain(q, k_cache, v_cache, start_pos,
                                            kv_valid_len, kv_min)
    T, H, D = q.shape
    K, KH, _ = k_cache.shape
    ffi.check_cuda(q, k_cache, v_cache)
    ffi.require(q.dtype == torch.float32 and q.is_contiguous(), "q must be contiguous f32")
    kv_bf16 = _kv_flag(k_cache, v_cache)
    ffi.require(k_cache.shape[2] == D and H % KH == 0, "GQA shapes disagree")
    ffi.require(D in (64, 128), f"head dim {D} not built (64, 128)")
    ffi.require(H // KH <= 64, "G above 64")
    ffi.require(q.data_ptr() % 16 == 0 and k_cache.data_ptr() % 16 == 0
                and v_cache.data_ptr() % 16 == 0
                and (k_cache.stride(0) * k_cache.element_size()) % 16 == 0,
                "q and cache rows must be 16-byte aligned")
    ffi.require(0 <= kv_min, "positions out of the cache")
    if not isinstance(start_pos, torch.Tensor):
        ffi.require(start_pos >= 0 and start_pos + T <= K, "positions out of the cache")
    if not isinstance(kv_valid_len, torch.Tensor):
        ffi.require(0 <= kv_valid_len <= K, "positions out of the cache")
    start = _position_i32(start_pos, q.device)
    valid = _position_i32(kv_valid_len, q.device)
    ffi.check_cuda(q, start, valid)
    out = torch.empty_like(q)
    _call("sv_causal_cache_attention", q.data_ptr(), k_cache.data_ptr(),
          v_cache.data_ptr(), out.data_ptr(), T, H, KH, D, k_cache.stride(0),
          start.data_ptr(), valid.data_ptr(), kv_min, kv_bf16, 1.0 / math.sqrt(D), ffi.stream())
    ffi.launch_counts["causal_cache_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B3: single-token decode attention
# ---------------------------------------------------------------------------

def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, start_pos, kv_min=0):
    """q: [H, D] at cache row start_pos; k_new/v_new: [KH, D] (not yet in the
    cache, always attended); cache rows [kv_min, start_pos) are attended.
    Returns [H, D] f32.

    With host ints it reads the live rows only.  With a device position (a
    one-element int tensor, as the decode step keeps it; kv_min an int or
    such a tensor) it is the fixed-shape form: every row of the [K] cache
    under a mask built from the position, with no host read."""
    H, D = q.shape
    KH = k_new.shape[0]
    G = H // KH
    if isinstance(start_pos, torch.Tensor):
        cols = torch.arange(k_cache.shape[0], device=q.device)
        km = kv_min.reshape(1) if isinstance(kv_min, torch.Tensor) else kv_min
        live = (cols >= km) & (cols < start_pos.reshape(1))
        mask = torch.cat([live, live.new_ones(1)])
        keys = torch.cat([k_cache.float(), k_new.float()[None]])
        vals = torch.cat([v_cache.float(), v_new.float()[None]])
    else:
        lo = min(kv_min, start_pos)
        keys = torch.cat([k_cache[lo:start_pos].float(), k_new.float()[None]])
        vals = torch.cat([v_cache[lo:start_pos].float(), v_new.float()[None]])
        mask = torch.ones(keys.shape[0], dtype=torch.bool, device=q.device)
    qc = (q.float() * (1.0 / math.sqrt(D))).reshape(KH, G, D)
    s = torch.einsum("kgd,skd->kgs", qc, keys)
    p = _masked_probs(s, mask)
    return torch.einsum("kgs,skd->kgd", p, vals).reshape(H, D)


def _position_i32(x, device) -> torch.Tensor:
    """A position as one int32 on `device`: a device tensor as it is
    (converted only if it is not int32), a host int filled in on the
    device (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        ffi.require(x.numel() == 1, "a position tensor holds one int")
        return x.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(x), dtype=torch.int32, device=device)


def decode_flash_attention(q, k_new, v_new, k_cache, v_cache, start_pos, kv_min=0):
    """One position's GQA attention over cache rows [kv_min, start_pos) plus
    the fresh row (kernel B3 on CUDA: one launch of a fixed grid, a thread
    block cluster of DECODE_MAX_BLOCKS blocks per KV head that merges its
    blocks' partials in shared memory).  The kernel reads start_pos and
    kv_min from device memory: pass them as one-element device int tensors
    (the decode step's position, which a CUDA graph holds) or host ints
    (filled in on the device here; kv_min 0 is passed as none)."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, start_pos, kv_min)
    H, D = q.shape
    K, KH, _ = k_cache.shape
    ffi.check_cuda(q, k_new, v_new, k_cache, v_cache)
    ffi.require(q.dtype == k_new.dtype == v_new.dtype == torch.float32,
                "q/k_new/v_new must be f32")
    ffi.require(q.is_contiguous() and k_new.is_contiguous() and v_new.is_contiguous(),
                "q/k_new/v_new must be contiguous")
    ffi.require(k_new.shape == (KH, D) and v_new.shape == (KH, D) and H % KH == 0
                and H // KH <= 8, "GQA shapes disagree (or G > 8)")
    kv_bf16 = _kv_flag(k_cache, v_cache)
    ffi.require(D in (64, 128), f"head dim {D} not built (64, 128)")
    for x, hi in ((start_pos, K), (kv_min, None)):
        if not isinstance(x, torch.Tensor):  # a device position is checked by its owner
            ffi.require(0 <= x and (hi is None or x <= hi), "positions out of the cache")
    ffi.require(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0
                and (k_cache.stride(0) * k_cache.element_size()) % 16 == 0,
                "cache rows must be 16-byte aligned")
    start = _position_i32(start_pos, q.device)
    km = None
    if isinstance(kv_min, torch.Tensor) or kv_min != 0:
        km = _position_i32(kv_min, q.device)
    ffi.check_cuda(q, start, *(() if km is None else (km,)))
    out = torch.empty_like(q)
    _call("sv_decode_attention", q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
          k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), H, KH, D,
          k_cache.stride(0), start.data_ptr(), None if km is None else km.data_ptr(),
          DECODE_MAX_BLOCKS, kv_bf16, 1.0 / math.sqrt(D), ffi.stream())
    ffi.launch_counts["decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B4: batched fresh-prefill causal attention
# ---------------------------------------------------------------------------

def _grouped_scores(q, keys):
    """q [B, T, H, D] (scaled here) against keys [B, S, KH, D] -> f32 scores
    [B, KH, G, T, S]."""
    B, T, H, D = q.shape
    KH = keys.shape[2]
    qc = (q.float() * (1.0 / math.sqrt(D))).reshape(B, T, KH, H // KH, D)
    return torch.einsum("btkgd,bskd->bkgts", qc, keys.float())


def batched_causal_attention_plain(q, k, v, kv_min):
    """q: [B, T, H, D]; k/v: [B, T, KH, D]; kv_min: [B] int.  In batch row b,
    query row r attends key column c iff kv_min[b] <= c <= r; the left-pad
    rows r < kv_min[b] give 0.  Returns [B, T, H, D] f32."""
    B, T, H, D = q.shape
    s = _grouped_scores(q, k)
    ar = torch.arange(T, device=q.device)
    km = kv_min.to(device=q.device, dtype=torch.int64)
    mask = (ar[None, :] <= ar[:, None])[None] & (ar[None, None, :] >= km[:, None, None])
    p = _masked_probs(s, mask[:, None, None])
    return torch.einsum("bkgts,bskd->btkgd", p, v.float()).reshape(B, T, H, D)


def _check_batched_qkv(q, k_new, v_new, KH: int) -> None:
    """B4 / B5 run on the tensor cores (csrc/mma_attention.cuh), any G =
    H / KH from 1 to 64; the fresh K/V rows are copied 16 bytes at a time."""
    B, T, H, D = q.shape
    ffi.require(q.dtype == k_new.dtype == v_new.dtype == torch.float32, "q/k/v must be f32")
    ffi.require(q.is_contiguous() and k_new.is_contiguous() and v_new.is_contiguous(),
                "q/k/v must be contiguous")
    ffi.require(k_new.shape == (B, T, KH, D) and v_new.shape == (B, T, KH, D)
                and KH <= H and H % KH == 0 and H // KH <= 64,
                "GQA shapes disagree (or G above 64)")
    ffi.require(D in (64, 128), f"head dim {D} not built (64, 128)")
    ffi.require(q.data_ptr() % 16 == 0 and k_new.data_ptr() % 16 == 0
                and v_new.data_ptr() % 16 == 0, "q/k/v rows must be 16-byte aligned")


def _rows_i32(x, B: int, device) -> torch.Tensor:
    """A per-row int vector [B] as contiguous int32 on `device` (a host int
    or a 0-dim tensor is broadcast; a host int is filled on the device, so
    no host copy is needed)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((B,), int(x), dtype=torch.int32, device=device)
    t = x.to(device=device, dtype=torch.int32)
    return (t.expand(B) if t.dim() == 0 else t.reshape(B)).contiguous()


def batched_causal_flash_attention(q, k, v, kv_min):
    """Batched fresh-block causal GQA self-attention with a left-pad mask
    (kernel B4 on CUDA, one launch for the whole batch, on the tensor cores:
    bf16 mma.sync on hi / lo splits of q, P and the f32 K/V)."""
    if not q.is_cuda:
        return batched_causal_attention_plain(q, k, v, kv_min)
    B, T, H, D = q.shape
    KH = k.shape[2]
    km = _rows_i32(kv_min, B, q.device)
    ffi.check_cuda(q, k, v, km)
    _check_batched_qkv(q, k, v, KH)
    out = torch.empty_like(q)
    _call("sv_batched_causal_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
          km.data_ptr(), out.data_ptr(), B, T, H, KH, D, 1.0 / math.sqrt(D), ffi.stream())
    ffi.launch_counts["batched_causal_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B5: batched delta prefill (block vs cache + itself)
# ---------------------------------------------------------------------------

def batched_cache_attention_plain(q, k_new, v_new, k_cache, v_cache, start_pos, kv_min,
                                  prompt_max=None, region_start=None):
    """q: [B, T, H, D] at cache rows start_pos + t; k_new/v_new: [B, T, KH, D]
    (not yet in the cache); k/v_cache: [B, KH, K, D].  Row b attends the cache
    columns [kv_min[b], start_pos) ∩ ([0, prompt_max[b]) ∪ [region_start[b],
    K)) (every column of [kv_min[b], start_pos) without prompt_max) and the
    fresh columns c <= t with start_pos + c >= kv_min[b].  Cache columns
    outside the window are zeroed before any product.  A row with no key
    gives 0.  Returns [B, T, H, D] f32.

    With a host int start_pos it reads the columns [0, start_pos) only.
    With a device start (a one-element int tensor, as multistream's round
    prefill graph keeps it) it is the fixed-shape form: every one of the K
    columns under a mask built from the tensor, with no host read."""
    B, T, H, D = q.shape
    dev = q.device
    km = kv_min.to(device=dev, dtype=torch.int64)
    if isinstance(start_pos, torch.Tensor):
        n, start = k_cache.shape[2], start_pos.reshape(1).to(device=dev, dtype=torch.int64)
    else:
        n = start = start_pos
    cols = torch.arange(n, device=dev)
    live = (cols[None, :] >= km[:, None]) & (cols[None, :] < start)        # [B, n]
    if prompt_max is not None:
        pm = _rows_i32(prompt_max, B, dev).long()
        rs = _rows_i32(region_start, B, dev).long()
        live = live & ((cols[None, :] < pm[:, None]) | (cols[None, :] >= rs[:, None]))
    keep = live[:, None, :, None]
    kc = torch.where(keep, k_cache[:, :, :n].float(), 0.0)                 # [B, KH, n, D]
    vc = torch.where(keep, v_cache[:, :, :n].float(), 0.0)
    s = torch.cat([_grouped_scores(q, kc.transpose(1, 2)),
                   _grouped_scores(q, k_new)], dim=-1)                    # [B, KH, G, T, n+T]
    ar = torch.arange(T, device=dev)
    fresh = ((ar[None, :] <= ar[:, None])[None]
             & (start + ar[None, None, :] >= km[:, None, None]))          # [B, T, T]
    mask = torch.cat([live[:, None, :].expand(B, T, n), fresh], dim=-1)
    p = _masked_probs(s, mask[:, None, None])
    out = (torch.einsum("bkgts,bksd->btkgd", p[..., :n], vc)
           + torch.einsum("bkgts,bskd->btkgd", p[..., n:], v_new.float()))
    return out.reshape(B, T, H, D)


def batched_decode_attention(q, k_new, v_new, k_cache, v_cache, pos, kv_min,
                             prompt_max=None, region_start=None):
    """The batched decode step's attention at a device position: the JAX
    package's `_batched_attention_two_part` (models/qwen3_decoder.py), which
    it computes outside any kernel.  q: [B, T, H, D] at cache rows pos + t
    (pos an int64 device tensor [1], batch-uniform); k_new/v_new: [B, T, KH,
    D]; k/v_cache: [B, KH, K, D] f32 or bf16 (an int8 cache widened by
    the caller).  Row b attends the cache columns [kv_min[b], pos) ∩ ([0,
    prompt_max[b]) ∪ [region_start[b], K)) (every column of [kv_min[b], pos)
    without prompt_max) and the fresh columns c <= t with pos + c >=
    kv_min[b]: the contract of `batched_cache_attention_plain`, whose slices
    need pos on the host.  Here every one of the K columns is read under a
    mask built from pos, so the shapes are fixed and nothing is read back:
    a CUDA graph holds it.  Returns [B, T, H, D] f32."""
    B, T, H, D = q.shape
    KH = k_new.shape[2]
    K = k_cache.shape[2]
    dev = q.device
    km = kv_min.to(device=dev, dtype=torch.int64)
    cols = torch.arange(K, device=dev)
    live = (cols[None, :] < pos.reshape(1)) & (cols[None, :] >= km[:, None])      # [B, K]
    if prompt_max is not None:
        pm = prompt_max.to(device=dev, dtype=torch.int64)
        rs = region_start.to(device=dev, dtype=torch.int64)
        live = live & ((cols[None, :] < pm[:, None]) | (cols[None, :] >= rs[:, None]))
    qc = (q.float() * (1.0 / math.sqrt(D))).reshape(B, T, KH, H // KH, D)
    s = torch.cat([torch.einsum("btkgd,bksd->bkgts", qc, k_cache.float()),
                   torch.einsum("btkgd,bskd->bkgts", qc, k_new.float())], dim=-1)
    ar = torch.arange(T, device=dev)
    fresh = ((ar[None, :] <= ar[:, None])[None]
             & (pos.reshape(1) + ar[None, None, :] >= km[:, None, None]))    # [B, T, T]
    mask = torch.cat([live[:, None, :].expand(B, T, K), fresh], dim=-1)
    p = _masked_probs(s, mask[:, None, None])
    out = (torch.einsum("bkgts,bksd->btkgd", p[..., :K], v_cache.float())
           + torch.einsum("bkgts,bskd->btkgd", p[..., K:], v_new.float()))
    return out.reshape(B, T, H, D)


def batched_cache_flash_attention(q, k_new, v_new, k_cache, v_cache, start_pos,
                                  kv_min, prompt_max=None, region_start=None):
    """Batched GQA attention of a fresh query block against the cache plus
    its own K/V, causal within the block (kernel B5 on CUDA, on the tensor
    cores: two mma.sync per product on a bf16 cache, three on the f32 cache
    and the fresh K/V).  The kernel reads start_pos, shared by the batch,
    from device memory: pass a one-element int32 / int64 device tensor (the
    round prefill's start, which a CUDA graph holds; checked by its owner)
    or a host int (filled in on the device here, and checked against the
    cache).  kv_min / prompt_max are [B]; region_start is an int or [B]
    (used only with prompt_max)."""
    if not q.is_cuda:
        return batched_cache_attention_plain(q, k_new, v_new, k_cache, v_cache, start_pos,
                                             kv_min, prompt_max, region_start)
    B, T, H, D = q.shape
    _, KH, K, _ = k_cache.shape
    km = _rows_i32(kv_min, B, q.device)
    ffi.check_cuda(q, k_new, v_new, k_cache, v_cache, km)
    _check_batched_qkv(q, k_new, v_new, KH)
    ffi.require(k_cache.dtype == v_cache.dtype
                and k_cache.dtype in (torch.bfloat16, torch.float32),
                f"cache must be bf16 or f32, got {k_cache.dtype}/{v_cache.dtype}")
    ffi.require(k_cache.shape == (B, KH, K, D) and v_cache.shape == k_cache.shape
                and k_cache.stride() == v_cache.stride() and k_cache.stride(3) == 1,
                "caches must be [B, KH, K, D] views with unit element stride")
    ffi.require(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0
                and all(x * k_cache.element_size() % 16 == 0 for x in k_cache.stride()[:3]),
                "cache rows must be 16-byte aligned")
    if not isinstance(start_pos, torch.Tensor):
        ffi.require(0 <= start_pos <= K, "positions out of the cache")
    start = _position_i32(start_pos, q.device)
    ffi.check_cuda(q, start)
    pm_ptr = rs_ptr = None
    rs_all = 0
    if prompt_max is not None:
        pm = _rows_i32(prompt_max, B, q.device)
        pm_ptr = pm.data_ptr()
        if isinstance(region_start, torch.Tensor) and region_start.dim() > 0:
            rs = _rows_i32(region_start, B, q.device)
            ffi.check_cuda(q, pm, rs)
            rs_ptr = rs.data_ptr()
        else:
            rs_all = int(region_start)
    out = torch.empty_like(q)
    _call("sv_batched_cache_attention", q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
          k_cache.data_ptr(), v_cache.data_ptr(), km.data_ptr(), pm_ptr, rs_ptr, rs_all,
          out.data_ptr(), B, T, H, KH, D, k_cache.stride(0), k_cache.stride(1),
          k_cache.stride(2), start.data_ptr(), int(k_cache.dtype == torch.bfloat16),
          1.0 / math.sqrt(D), ffi.stream())
    ffi.launch_counts["batched_cache_attention"] += 1
    return out
