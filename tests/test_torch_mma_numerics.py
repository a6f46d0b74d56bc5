"""The arithmetic of the port's tensor-core kernels, emulated on the CPU.

The tensor-core kernels run only on the card (tests/test_torch_cuda.py);
here their arithmetic is reproduced in torch so that its error budget is
pinned before the card sees it:

  * B2 on a bf16 cache (csrc/mma_attention.cuh): q (scaled) and P are split
    into bf16 hi + lo, every product is two bf16 products summed in f32,
    and the keys are walked in 64-key tiles from kv_min with an online
    softmax.  Held against `causal_cache_attention_plain` and the JAX
    `causal_cache_flash_attention` (Pallas, interpret mode off-TPU) within
    1e-4, the card's tolerance for the kernel;
  * the tensor-core greedy head (csrc/argmax_matvec.cu): per 128-row tile
    of the table, each column's best 64-bit key (ordered value bits,
    inverted index), merged across tiles by max;
  * `head_route`, which picks the head's route on the card.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.kernels import flash_attention as jfa
from smolvision_tpu_torch.kernels import argmax_matvec as tam
from smolvision_tpu_torch.kernels import ffi
from smolvision_tpu_torch.kernels import flash_attention as tfa

ATOL = 1e-4        # chip_smoke.KERNEL_ATOL: the card's kernel-vs-plain tolerance
KEYS_PER_TILE = 64
HEAD_TILE_ROWS = 128


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def mma_b2_emulated(q, k_cache, v_cache, start_pos, kv_valid_len, kv_min, split=True):
    """The bf16-cache B2 kernel's arithmetic: hi / lo bf16 operands (or one
    bf16 rounding with split=False), f32 sums, 64-key tiles from kv_min."""
    T, H, D = q.shape
    KH = k_cache.shape[1]
    G = H // KH
    qs = q.float() * (1.0 / math.sqrt(D))
    q_hi = _bf16(qs)
    q_lo = _bf16(qs - q_hi) if split else torch.zeros_like(qs)
    row_hi = torch.clamp(start_pos + torch.arange(T) + 1, max=kv_valid_len)
    hi = max(int(row_hi.max()), kv_min)
    m = torch.full((T, H), tfa.NEG_INF)
    l = torch.zeros((T, H))
    o = torch.zeros((T, H, D))
    for k0 in range(kv_min, hi, KEYS_PER_TILE):
        kt = k_cache[k0:k0 + KEYS_PER_TILE].float().repeat_interleave(G, dim=1)   # [n, H, D]
        vt = v_cache[k0:k0 + KEYS_PER_TILE].float().repeat_interleave(G, dim=1)
        s = (torch.einsum("thd,nhd->thn", q_hi, kt) + torch.einsum("thd,nhd->thn", q_lo, kt))
        mask = (k0 + torch.arange(kt.shape[0]))[None, :] < row_hi[:, None]       # [T, n]
        s = torch.where(mask[:, None, :], s, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask[:, None, :], torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        m = m_new
        p_hi = _bf16(p)
        p_lo = _bf16(p - p_hi) if split else torch.zeros_like(p)
        o = (o * alpha[..., None] + torch.einsum("thn,nhd->thd", p_hi, vt)
             + torch.einsum("thn,nhd->thd", p_lo, vt))
    return o / torch.clamp(l, min=tfa.DENOM_FLOOR)[..., None]


def _b2_case(T, start, kv_min, seed, K=512, H=16, KH=8, D=128):
    """q f32 and a bf16 cache holding the block, with +-999 in every row at
    or past kv_valid (the pad rows prefill writes)."""
    rng = np.random.default_rng(seed)
    valid = start + T - (3 if start == 0 and T > 3 else 0)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k = torch.from_numpy(rng.standard_normal((K, KH, D)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((K, KH, D)).astype(np.float32)).to(torch.bfloat16)
    k[valid:], v[valid:] = 999.0, -999.0
    return torch.from_numpy(q), k, v, valid


@pytest.mark.parametrize("T", [5, 64, 200])
@pytest.mark.parametrize("start,kv_min", [(0, 0), (300, 0), (150, 37)])
def test_b2_hi_lo_split_matches_plain_and_pallas(T, start, kv_min):
    """The main shape's head layout (H 16, KH 8, D 128); T 5 is the --spec
    verify block, T 200 not a multiple of the 64-key tile."""
    q, k, v, valid = _b2_case(T, start, kv_min, seed=T * 7 + start)
    got = mma_b2_emulated(q, k, v, start, valid, kv_min)
    plain = tfa.causal_cache_attention_plain(q, k, v, start, valid, kv_min)
    torch.testing.assert_close(got, plain, rtol=0, atol=ATOL)
    pallas = jfa.causal_cache_flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.float().numpy()), jnp.asarray(v.float().numpy()),
        jnp.int32(start), jnp.int32(valid), gqa_groups=2, block_q=T, kv_min=jnp.int32(kv_min))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)


def test_b2_needs_the_lo_halves():
    """One bf16 rounding of q and P (no lo halves) misses the f32 contract by
    far more than the split does: the split is what keeps 1e-4."""
    q, k, v, valid = _b2_case(200, 150, 37, seed=1)
    plain = tfa.causal_cache_attention_plain(q, k, v, 150, valid, 37)
    err_split = float((mma_b2_emulated(q, k, v, 150, valid, 37) - plain).abs().max())
    err_one = float((mma_b2_emulated(q, k, v, 150, valid, 37, split=False) - plain).abs().max())
    assert err_split <= ATOL < err_one
    assert err_one > 10 * err_split


def _pack(values: np.ndarray, index: np.ndarray) -> np.ndarray:
    """The head kernel's 64-bit keys: order-preserving f32 bits << 32 |
    ~index (the largest key is the largest value, then the lowest index)."""
    u = np.where(values == 0.0, np.float32(0.0), values).astype(np.float32).view(np.uint32)
    u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    return (u << np.uint64(32)) | (~index.astype(np.uint32)).astype(np.uint64)


def tc_head_emulated(h, w, scale=None):
    """Per 128-row tile of w, each row of h's best key over the tile's rows;
    the tiles' keys merged by max (the shared- and global-memory atomicMax)."""
    logits = tam.logits_plain(h, w, scale).numpy()              # [R, V] f32
    R, V = logits.shape
    best = np.zeros(R, np.uint64)
    for v0 in range(0, V, HEAD_TILE_ROWS):
        idx = np.arange(v0, min(v0 + HEAD_TILE_ROWS, V))
        keys = _pack(logits[:, idx], np.broadcast_to(idx, (R, len(idx))))
        best = np.maximum(best, keys.max(axis=1))
    return (~(best & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int32)


@pytest.mark.parametrize("R", [9, 33])
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_tc_head_keys_give_the_first_index_on_ties(R, kind):
    """Planted winners, an exact tie across tiles (rows 7 and V - 2: the
    first wins), a zero row (-0 and +0 compare equal) and V not a multiple
    of the 128-row tile: the keys' argmax equals torch.argmax."""
    rng = np.random.default_rng(R)
    V, H = 1000, 128
    h = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((V, H)).astype(np.float32)) * 0.05
    for r in range(1, R):
        w[(37 * r + 11) % V] = torch.sign(h[r]) * 0.5
    w[7] = w[V - 2] = torch.sign(h[0]) * 0.5
    scale = None
    if kind == "int8":
        scale = w.abs().amax(-1) / 127.0
        w = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
        scale[V - 2] = scale[7]
    else:
        w = w.to(torch.bfloat16)
    got = tc_head_emulated(h, w, scale)
    assert got[0] == 7
    assert got.tolist() == tam.argmax_matvec_plain(h, w, scale).tolist()
    zero = tc_head_emulated(torch.zeros(1, H), w, scale)
    assert zero.tolist() == [0]


BF16, INT8 = tam.HEAD_TC_ABOVE[torch.bfloat16], tam.HEAD_TC_ABOVE[torch.int8]


@pytest.mark.parametrize("R,dtype,route", [
    (1, torch.bfloat16, "cuda_core"),
    (BF16, torch.bfloat16, "cuda_core"),
    (BF16 + 1, torch.bfloat16, "tensor_core"),
    (64, torch.bfloat16, "tensor_core"),
    (INT8, torch.int8, "cuda_core"),
    (INT8 + 1, torch.int8, "tensor_core"),
    (1, torch.float32, "cuda_core"),
    (max(BF16, INT8) + 1, torch.float32, "cuda_core"),
    (4096, torch.float32, "cuda_core"),
])
def test_head_route(R, dtype, route):
    assert tam.head_route(R, dtype) == route


@pytest.mark.parametrize("R", [0, -1])
def test_head_route_refuses_no_rows(R):
    with pytest.raises(ValueError, match="at least one row"):
        tam.head_route(R, torch.bfloat16)


def test_head_launch_keys_and_cpu_tensors():
    """One launch key per route and table type, each in ffi.launch_counts;
    CPU tensors take the plain version on either route and count nothing."""
    keys = {tam.launch_key(r, d) for r in ("cuda_core", "tensor_core")
            for d in (torch.bfloat16, torch.int8)}
    assert keys == {"argmax_matvec", "argmax_matvec_tc", "argmax_matvec_q8",
                    "argmax_matvec_q8_tc"}
    assert keys <= set(ffi.launch_counts)
    before = dict(ffi.launch_counts)
    h = torch.randn(16, 64)
    w = torch.randn(300, 64).to(torch.bfloat16)
    want = tam.argmax_matvec_plain(h, w)
    for route in (None, "tensor_core", "cuda_core"):
        assert torch.equal(tam.argmax_matvec(h, w, route=route), want)
    assert ffi.launch_counts == before
