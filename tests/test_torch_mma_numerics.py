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
  * B4 and B5 as the card runs them (`mma_core_emulated`): 64-row blocks of
    floor(64 / G) queries of each of a KV head's G heads (dead rows past G
    times that), one warp group walking the key tiles with one online
    softmax; f32 K / V segments in 32-key tiles split into bf16 hi + lo,
    each product three bf16 products (hi.hi + lo.hi + hi.lo); bf16 cache
    segments in 64-key tiles, two products; B5's cache window first, then
    the fresh block.  Held against the plain versions and the JAX Pallas
    kernels within 1e-4;
  * B1 as the card runs it (`window_emulated`): up to 128 rows, a
    (window, head) is resident in one block (or its 16-row warps split over
    two): the window's keys zero-filled to a multiple of 16, q, K and V
    split into bf16 hi + lo, three products per product, one exact
    softmax (exp2 of log2-unit scores on the card, exp here: they differ
    by a few ulp), P split; above 128 rows, query tiles of 64 rows walk one
    non-causal f32 segment (`mma_core_emulated` with G 1).  Held against
    `window_attention_plain` and the JAX `window_flash_attention` (Pallas,
    interpret mode) within 1e-4; B2 on an f32 cache runs the causal f32
    segment, held likewise at G 2 and G 7;
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


MMA_ROWS = 64        # csrc/mma_attention.cuh: kMmaRows
KEYS_F32 = 32        # kMmaKeysF32: keys per tile of an f32 segment


def block_rows(T: int, G: int, t0: int):
    """The kernel's row map of the block at query t0: row r holds query t0 +
    r % P of head r // P (P = 64 // G), or nothing (-1, -1) when r >= G * P
    (a dead row) or the query is past T."""
    P = MMA_ROWS // G
    r = np.arange(MMA_ROWS)
    t = t0 + r % P
    live = (r < G * P) & (t < T)
    return np.where(live, t, -1), np.where(live, r // P, -1)


def _split(x: torch.Tensor):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def mma_core_emulated(q, segments, three=True):
    """One (batch row, KV head) of the tensor-core core: q [T, G, D] f32
    (the G query heads of the KV head), `segments` a list of (k, v, lo, hi,
    causal, off): k / v [N, D] f32 (split into hi + lo: three products, or
    with three=False rounded to bf16 once: two) or bf16 (exact: two
    products), columns [lo, hi), causal rows needing c < t + off + 1.
    Returns [T, G, D] f32; a query with no key gives 0."""
    T, G, D = q.shape
    P = MMA_ROWS // G
    out = torch.zeros(T, G, D)
    for t0 in range(0, T, P):
        rt, rh = block_rows(T, G, t0)
        rt_t, live = torch.from_numpy(rt), torch.from_numpy(rt >= 0)
        t_last = min(t0 + P, T) - 1
        qb = torch.zeros(MMA_ROWS, D)
        qb[live] = q[rt[live.numpy()], rh[live.numpy()]] * (1.0 / math.sqrt(D))
        q_hi, q_lo = _split(qb)
        m = torch.full((MMA_ROWS,), tfa.NEG_INF)
        l = torch.zeros(MMA_ROWS)
        o = torch.zeros(MMA_ROWS, D)
        for k, v, lo, hi, causal, off in segments:
            f32 = k.dtype == torch.float32
            nk = KEYS_F32 if f32 else KEYS_PER_TILE
            hi = min(hi, t_last + off + 1) if causal else hi
            row_hi = torch.where(live, torch.clamp(rt_t + off + 1, max=hi) if causal
                                 else torch.full_like(rt_t, hi), lo)
            for k0 in range(lo, hi, nk):
                n = min(k0 + nk, hi) - k0            # rows past hi are zero-filled
                kt, vt = k[k0:k0 + n].float(), v[k0:k0 + n].float()
                if f32 and three:
                    (k_hi, k_lo), (v_hi, v_lo) = _split(kt), _split(vt)
                else:   # exact in bf16, or rounded once (three=False)
                    k_hi, v_hi = _bf16(kt), _bf16(vt)
                    k_lo, v_lo = torch.zeros_like(kt), torch.zeros_like(vt)
                s = q_hi @ k_hi.T + q_lo @ k_hi.T + q_hi @ k_lo.T
                mask = (k0 + torch.arange(n))[None, :] < row_hi[:, None]
                s = torch.where(mask, s, tfa.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(mask, torch.exp(s - m_new[:, None]), 0.0)
                l = l * alpha + p.sum(-1)
                m = m_new
                p_hi, p_lo = _split(p)
                o = o * alpha[:, None] + p_hi @ v_hi + p_lo @ v_hi + p_hi @ v_lo
        res = o / torch.clamp(l, min=tfa.DENOM_FLOOR)[:, None]
        out[rt[live.numpy()], rh[live.numpy()]] = res[live]
    return out


def b4_emulated(q, k, v, kv_min, three=True):
    """B4: per (batch row, KV head) one causal f32 segment from kv_min[b]."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    out = torch.zeros(B, T, H, D)
    for b in range(B):
        lo = min(max(int(kv_min[b]), 0), T)
        for kh in range(KH):
            seg = (k[b, :, kh], v[b, :, kh], lo, T, True, 0)
            out[b, :, kh * G:(kh + 1) * G] = mma_core_emulated(
                q[b, :, kh * G:(kh + 1) * G], [seg], three)
    return out


def b5_emulated(q, k_new, v_new, k_cache, v_cache, start, kv_min, prompt_max=None,
                region_start=None, three=True):
    """B5: the cache window's two ranges (segments of the cache's type, not
    causal), then the fresh f32 block from max(kv_min[b] - start, 0),
    causal, in one online softmax."""
    B, T, H, D = q.shape
    KH = k_new.shape[2]
    G = H // KH
    out = torch.zeros(B, T, H, D)
    for b in range(B):
        km = max(int(kv_min[b]), 0)
        hi1 = lo2 = start
        if prompt_max is not None:
            rs = int(region_start if np.ndim(region_start) == 0 else region_start[b])
            hi1 = max(km, min(start, int(prompt_max[b])))
            lo2 = max(hi1, km, rs)
        for kh in range(KH):
            kc, vc = k_cache[b, kh], v_cache[b, kh]
            segs = [(kc, vc, km, hi1, False, 0), (kc, vc, lo2, start, False, 0)] if start else []
            segs.append((k_new[b, :, kh], v_new[b, :, kh], min(max(km - start, 0), T), T,
                         True, 0))
            out[b, :, kh * G:(kh + 1) * G] = mma_core_emulated(
                q[b, :, kh * G:(kh + 1) * G], segs, three)
    return out


@pytest.mark.parametrize("G", [1, 2, 3, 7, 8, 14, 64])
@pytest.mark.parametrize("T", [1, 5, 100, 130])
def test_block_rows_cover_every_query_once(G, T):
    """Over the ceil(T / P) blocks of a KV head, the kernel's row map holds
    every (query, head) exactly once, no row names a head past G (at G 7, P
    9: row 63 would be head 7, the next KV head's head 0, without the dead
    rows), and each block has 64 - G * P dead rows."""
    P = MMA_ROWS // G
    seen = np.zeros((T, G), int)
    for t0 in range(0, T, P):
        rt, rh = block_rows(T, G, t0)
        assert rh.max() < G
        assert (rt[G * P:] == -1).all()
        np.add.at(seen, (rt[rt >= 0], rh[rt >= 0]), 1)
    assert (seen == 1).all()


def _batched_case(seed, B, T, H, KH, D=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, D), (B, T, KH, D), (B, T, KH, D)))


@pytest.mark.parametrize("B,T,H,KH,kvmins", [
    (2, 128, 4, 2, (0, 37)),           # G 2
    (3, 100, 14, 2, (0, 100, 5)),      # G 7, an all-pad row, T not a multiple of P 9
    (2, 96, 12, 4, (3, 61)),           # G 3
    (2, 64, 4, 4, (0, 0)),             # G 1
])
def test_b4_three_product_split_matches_plain_and_pallas(B, T, H, KH, kvmins):
    q, k, v = _batched_case(B * T + H, B, T, H, KH)
    kv_min = np.asarray(kvmins, np.int32)
    got = b4_emulated(*map(torch.from_numpy, (q, k, v, kv_min)))
    plain = tfa.batched_causal_attention_plain(*map(torch.from_numpy, (q, k, v, kv_min)))
    torch.testing.assert_close(got, plain, rtol=0, atol=ATOL)
    pallas = jfa.batched_causal_flash_attention(*map(jnp.asarray, (q, k, v, kv_min)),
                                                gqa_groups=H // KH, block_q=T, block_k=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)
    for b, lo in enumerate(kvmins):
        assert not got[b, :lo].any(), "left-pad rows must give exactly 0"


@pytest.mark.parametrize("cache", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,T,K,H,KH,start,kvmins,window", [
    (2, 64, 128, 4, 2, 0, (0, 0), "prompts"),          # serving's wave: no cache read
    (3, 100, 256, 14, 2, 160, (0, 9, 170), "pm_rs"),   # G 7, an empty cache window
    (2, 64, 256, 12, 4, 192, (5, 0), "none"),          # G 3, every column of the window
    (2, 128, 384, 4, 2, 200, (0, 30), "pm_rs"),        # G 2, two cache ranges
])
def test_b5_three_product_split_matches_plain_and_pallas(cache, B, T, K, H, KH, start, kvmins,
                                                         window):
    rng = np.random.default_rng(B * K + H + start)
    q, kn, vn = _batched_case(B * K + H, B, T, H, KH)
    kc, vc = (torch.from_numpy(rng.standard_normal((B, KH, K, 64)).astype(np.float32))
              .to(getattr(torch, cache)) for _ in range(2))
    kv_min = np.asarray(kvmins, np.int32)
    pm = rs = None
    if window == "prompts":
        pm, rs = np.asarray([64, 17][:B], np.int32), np.int32(1 << 30)
    elif window == "pm_rs":
        pm = rng.integers(1, start + 1, B).astype(np.int32)
        rs = rng.integers(start // 2, start + 1, B).astype(np.int32)
    args = (start, torch.from_numpy(kv_min), None if pm is None else torch.from_numpy(pm),
            rs if rs is None or np.ndim(rs) == 0 else torch.from_numpy(rs))
    tq, tkn, tvn = map(torch.from_numpy, (q, kn, vn))
    got = b5_emulated(tq, tkn, tvn, kc, vc, *args)
    plain = tfa.batched_cache_attention_plain(tq, tkn, tvn, kc, vc, *args)
    torch.testing.assert_close(got, plain, rtol=0, atol=ATOL)
    pallas = jfa.batched_cache_flash_attention(
        *map(jnp.asarray, (q, kn, vn, kc.float().numpy(), vc.float().numpy())),
        jnp.int32(start), jnp.asarray(kv_min), prompt_max=None if pm is None else jnp.asarray(pm),
        region_start=None if rs is None else jnp.asarray(rs, jnp.int32), gqa_groups=H // KH,
        block_q=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)
    for b, lo in enumerate(kvmins):
        if lo > start:
            assert not got[b, :lo - start].any(), "rows with no key must give exactly 0"


def test_b4_b5_need_three_products():
    """With f32 K and V rounded to bf16 once (B2's two-product form) the
    emulation misses the f32 contract at the inputs the three-product form
    keeps within 1e-4: the lo halves of K and V are what keeps it."""
    q, k, v = _batched_case(3, 2, 128, 14, 2)
    kv_min = torch.tensor([0, 21])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = tfa.batched_causal_attention_plain(tq, tk, tv, kv_min)
    err_three = float((b4_emulated(tq, tk, tv, kv_min) - plain).abs().max())
    err_two = float((b4_emulated(tq, tk, tv, kv_min, three=False) - plain).abs().max())
    assert err_three <= ATOL < err_two
    assert err_two > 10 * err_three
    kc = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 2, 256, 64))
                          .astype(np.float32))
    plain = tfa.batched_cache_attention_plain(tq, tk, tv, kc, kc, 200, kv_min)
    err_three = float((b5_emulated(tq, tk, tv, kc, kc, 200, kv_min) - plain).abs().max())
    err_two = float((b5_emulated(tq, tk, tv, kc, kc, 200, kv_min, three=False)
                     - plain).abs().max())
    assert err_three <= ATOL < err_two


WINDOW_BLOCK_ROWS = 128   # csrc/window_attention.cu: kWinRows


def window_blocks(S: int, row_blocks: int):
    """The resident route's blocks of a (window, head), as its launcher
    builds them: ceil(S / 16) warps of 16 rows split over `row_blocks`
    blocks; block b holds rows [b * rb, (b + 1) * rb), rows >= S dead."""
    warps16 = -(-S // 16)
    warps = -(-warps16 // row_blocks)
    rb = 16 * warps
    return [range(b * rb, (b + 1) * rb) for b in range(-(-warps16 // warps))]


def window_emulated(q, k, v, lens, row_blocks=1, three=True):
    """B1 on the card: q / k / v [W, S, H, D] f32, lens [W].  Up to 128 rows
    the window-resident route: keys [0, len) zero-filled to a multiple of
    16, q (scaled), K, V and P split into bf16 hi + lo (or with three=False
    rounded to bf16 once), each product three bf16 products summed in f32,
    one exact softmax over the valid keys; above 128 rows query tiles of 64
    rows against one non-causal f32 segment [0, len)."""
    W, S, H, D = q.shape
    out = torch.zeros(W, S, H, D)
    for w in range(W):
        n = min(max(int(lens[w]), 0), S)
        for h in range(H):
            if S > WINDOW_BLOCK_ROWS:
                out[w, :, h:h + 1] = mma_core_emulated(
                    q[w, :, h:h + 1], [(k[w, :, h], v[w, :, h], 0, n, False, 0)], three)
                continue
            nk = -(-n // 16) * 16
            kt, vt = torch.zeros(nk, D), torch.zeros(nk, D)
            kt[:n], vt[:n] = k[w, :n, h], v[w, :n, h]
            (k_hi, k_lo), (v_hi, v_lo) = _split(kt), _split(vt)
            if not three:
                k_hi, v_hi = _bf16(kt), _bf16(vt)
                k_lo, v_lo = torch.zeros_like(kt), torch.zeros_like(vt)
            for rows in window_blocks(S, row_blocks):
                live = [r for r in rows if r < S]        # dead rows load and store nothing
                if not live:
                    continue
                qb = torch.zeros(len(rows), D)
                qb[:len(live)] = q[w, live, h] * (1.0 / math.sqrt(D))
                q_hi, q_lo = _split(qb)
                if not three:
                    q_hi, q_lo = _bf16(qb), torch.zeros_like(qb)
                s = q_hi @ k_hi.T + q_lo @ k_hi.T + q_hi @ k_lo.T            # [rb, nk]
                mask = (torch.arange(nk) < n)[None, :]
                m = torch.where(mask, s, tfa.NEG_INF).amax(-1, keepdim=True) if nk else s
                p = torch.where(mask, torch.exp(s - m), 0.0)
                l = p.sum(-1)
                p_hi, p_lo = _split(p)
                if not three:
                    p_hi, p_lo = _bf16(p), torch.zeros_like(p)
                o = p_hi @ v_hi + p_lo @ v_hi + p_hi @ v_lo
                res = o / torch.clamp(l, min=tfa.DENOM_FLOOR)[:, None]
                out[w, live, h] = res[:len(live)]
    return out


def _window_case(seed, S, H, lens, D=64):
    """q / k / v [W, S, H, D] f32 with +-999 in every pad key row."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((len(lens), S, H, D)).astype(np.float32) for _ in range(3))
    for w, n in enumerate(lens):
        k[w, n:], v[w, n:] = 999.0, -999.0
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("S,H,lens,row_blocks", [
    (13, 2, [13, 1, 0], 1),               # --enc-window-sec's shortest window: one warp
    (26, 3, [26, 9], 2),                  # two warps, split over two blocks
    (100, 2, [100, 64, 17, 0], 1),        # Qwen2.5-Omni's window
    (104, 2, [104, 104, 52, 0], 1),       # the offline path's windows
    (104, 3, [1, 77, 104], 2),            # split: the second block's last warp is dead
    (208, 2, [208, 130, 0], 1),           # above 128 rows: the query-tiled route
    (208, 1, [129, 5], 1),
])
def test_b1_window_matches_plain_and_pallas(S, H, lens, row_blocks):
    q, k, v, kl = _window_case(S * 7 + sum(lens), S, H, lens)
    got = window_emulated(*map(torch.from_numpy, (q, k, v)), kl, row_blocks)
    plain = tfa.window_attention_plain(*map(torch.from_numpy, (q, k, v, kl)))
    torch.testing.assert_close(got, plain, rtol=0, atol=ATOL)
    pallas = jfa.window_flash_attention(*map(jnp.asarray, (q, k, v, kl)))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)
    for w, n in enumerate(lens):
        assert n or not got[w].any(), "an all-pad window must give exactly 0"


def test_b1_needs_the_lo_halves():
    """With q, K, P and V rounded to bf16 once (one bf16 product each) the
    emulation misses the f32 contract at the offline path's windows, where
    the three-product split keeps 1e-4."""
    q, k, v, kl = _window_case(3, 104, 4, [104, 104, 52, 0])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = tfa.window_attention_plain(tq, tk, tv, torch.from_numpy(kl))
    err_three = float((window_emulated(tq, tk, tv, kl) - plain).abs().max())
    err_one = float((window_emulated(tq, tk, tv, kl, three=False) - plain).abs().max())
    assert err_three <= ATOL < err_one
    assert err_one > 10 * err_three


@pytest.mark.parametrize("S", [1, 13, 16, 17, 100, 104, 128])
@pytest.mark.parametrize("row_blocks", [1, 2])
def test_window_blocks_cover_every_row_once(S, row_blocks):
    """The resident route's blocks hold every row of the window exactly
    once, at most 128 rows (8 warps) each; the rows past S are the last
    block's dead rows, fewer than one warp's unless a whole warp is dead."""
    blocks = window_blocks(S, row_blocks)
    rows = [r for b in blocks for r in b]
    assert sorted(r for r in rows if r < S) == list(range(S))
    assert len(blocks) <= row_blocks and all(len(b) <= WINDOW_BLOCK_ROWS for b in blocks)
    assert len(rows) - S < 32


@pytest.mark.parametrize("W,S,H,sms,want", [
    (4, 104, 14, 132, 2),      # offline: 56 blocks, split into 112 (one wave)
    (24, 104, 14, 132, 1),     # -S 20's encode call: 336 blocks already
    (32, 104, 14, 132, 1),     # a --serve 64 encode group
    (5, 104, 14, 132, 1),      # 140 split blocks would need a second wave
    (4, 16, 14, 132, 1),       # one warp's rows: nothing to split
    (2, 208, 14, 132, 4),      # the query-tiled route: ceil(208 / 64) tiles
    (2, 129, 14, 132, 3),
])
def test_window_row_blocks(W, S, H, sms, want):
    assert tfa.window_row_blocks(W, S, H, sms) == want


def _b2_f32_case(T, start, valid, kv_min, H, KH, seed, K=512, D=128):
    """q and an f32 cache holding the block, +-999 in every row at or past
    kv_valid."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((K, KH, D)).astype(np.float32) for _ in range(2))
    k[valid:], v[valid:] = 999.0, -999.0
    return q, k, v


@pytest.mark.parametrize("H,KH", [(16, 8), (28, 4)])     # G 2 (0.6B) and G 7 (Qwen2.5-Omni)
@pytest.mark.parametrize("T,start,valid,kv_min", [(100, 0, 97, 0), (5, 300, 305, 17)])
def test_b2_f32_cache_causal_segment_matches_plain_and_pallas(H, KH, T, start, valid, kv_min):
    """B2 on an f32 cache (the --f32 engine): one causal f32 segment at
    start_pos, [kv_min, kv_valid), 32-key tiles split into hi + lo, three
    products, as the card runs it."""
    q, k, v = _b2_f32_case(T, start, valid, kv_min, H, KH, seed=T + H + start)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    G = H // KH
    got = torch.zeros(T, H, 128)
    for kh in range(KH):
        seg = (tk[:, kh], tv[:, kh], kv_min, valid, True, start)
        got[:, kh * G:(kh + 1) * G] = mma_core_emulated(tq[:, kh * G:(kh + 1) * G], [seg])
    plain = tfa.causal_cache_attention_plain(tq, tk, tv, start, valid, kv_min)
    torch.testing.assert_close(got, plain, rtol=0, atol=ATOL)
    pallas = jfa.causal_cache_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(start), jnp.int32(valid),
        gqa_groups=G, block_q=T, kv_min=jnp.int32(kv_min))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)


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
