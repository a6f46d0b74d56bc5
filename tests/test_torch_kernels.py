"""Port attention kernels: the plain torch versions against the Pallas kernels.

On the CPU each wrapper of smolvision_tpu_torch.kernels.flash_attention runs
its plain version; the JAX side runs the Pallas kernel in interpret mode
(automatic off-TPU).  Same numpy inputs on both sides.  Tolerance 2e-5
(as tests/test_kernels.py): both are f32 softmax-attention over <= 512 keys,
differing only in summation order.

The hand-written kernels themselves are held against these plain versions
on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.kernels import flash_attention as jfa
from smolvision_tpu_torch.kernels import ffi
from smolvision_tpu_torch.kernels import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("W,S,H,D,valid,garbage", [
    (2, 104, 4, 64, [104, 40], False),
    (1, 16, 2, 32, [16], False),
    (3, 8, 1, 8, [8, 5, 1], False),
    (4, 104, 2, 32, [104, 104, 52, 0], False),   # a whole pad window (kv_len 0)
    (2, 104, 2, 64, [104, 17], True),            # +-999 junk in the pad keys
])
def test_window_plain_matches_pallas(W, S, H, D, valid, garbage):
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, W, S, H, D) for _ in range(3))
    if garbage:
        for w, n in enumerate(valid):
            k[w, n:] = 999.0
            v[w, n:] = -999.0
    lens = np.asarray(valid, np.int32)
    got = tfa.window_flash_attention(*map(torch.from_numpy, (q, k, v, lens))).numpy()
    want = np.asarray(jfa.window_flash_attention(*map(jnp.asarray, (q, k, v, lens))))
    # pad query rows attend the valid keys on both sides: compare every row
    np.testing.assert_allclose(got, want, **TOL)
    for w, n in enumerate(valid):
        if n == 0:
            assert not got[w].any(), "a window with no valid key must give exactly 0"


@pytest.mark.parametrize("T,K,H,KH,D,start,valid,kv_min", [
    (128, 256, 4, 2, 64, 0, 128, 0),
    (128, 512, 8, 4, 32, 100, 228, 0),
    (256, 256, 2, 1, 128, 0, 256, 0),
    (128, 256, 4, 2, 64, 0, 100, 0),       # pad rows past the valid length
    (64, 256, 4, 2, 16, 96, 150, 40),      # kv_min > 0 (left-pad layout)
    (100, 256, 14, 2, 64, 0, 97, 0),       # G 7 (does not divide the card's 64-row block)
    (64, 256, 14, 2, 64, 96, 150, 40),     # G 7, kv_min > 0
    (100, 256, 12, 4, 64, 20, 110, 0),     # G 3
])
def test_causal_cache_plain_matches_pallas(T, K, H, KH, D, start, valid, kv_min):
    rng = np.random.default_rng(1)
    q = _rand(rng, T, H, D)
    k = _rand(rng, K, KH, D)
    v = _rand(rng, K, KH, D)
    got = tfa.causal_cache_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), start, valid,
        kv_min=kv_min).numpy()
    want = jfa.causal_cache_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(start), jnp.int32(valid),
        gqa_groups=H // KH, kv_min=jnp.int32(kv_min))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_causal_cache_plain_ignores_stale_rows():
    """Rows at or past kv_valid_len (+-999 junk) must not leak in: exactly
    the same output as with clean rows."""
    rng = np.random.default_rng(2)
    T, K, H, KH, D = 128, 256, 2, 2, 32
    q = torch.from_numpy(_rand(rng, T, H, D))
    k1, v1 = _rand(rng, K, KH, D), _rand(rng, K, KH, D)
    k2, v2 = k1.copy(), v1.copy()
    k2[100:] = 999.0
    v2[100:] = -999.0
    a = tfa.causal_cache_flash_attention(q, torch.from_numpy(k1), torch.from_numpy(v1), 0, 100)
    b = tfa.causal_cache_flash_attention(q, torch.from_numpy(k2), torch.from_numpy(v2), 0, 100)
    assert torch.equal(a, b)


@pytest.mark.parametrize("K,H,KH,D,start,kvmin", [
    (256, 4, 2, 64, 100, 0),
    (512, 8, 4, 128, 0, 0),       # empty cache: self-attention only
    (512, 2, 2, 32, 511, 0),
    (256, 4, 2, 64, 100, 30),     # left-padded batch layout
])
def test_decode_plain_matches_pallas(K, H, KH, D, start, kvmin):
    rng = np.random.default_rng(5)
    q = _rand(rng, H, D)
    k_new, v_new = _rand(rng, KH, D), _rand(rng, KH, D)
    k, v = _rand(rng, K, KH, D), _rand(rng, K, KH, D)
    k[start:] = 999.0  # rows at or past start_pos are never attended
    v[start:] = -999.0
    got = tfa.decode_flash_attention(*map(torch.from_numpy, (q, k_new, v_new, k, v)),
                                     start, kvmin).numpy()
    want = jfa.decode_flash_attention(*map(jnp.asarray, (q, k_new, v_new, k, v)),
                                      jnp.int32(start), jnp.int32(kvmin), gqa_groups=H // KH)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(7)
    before = dict(ffi.launch_counts)
    q = torch.from_numpy(_rand(rng, 1, 8, 2, 32))
    lens = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(tfa.window_flash_attention(q, q, q, lens),
                       tfa.window_attention_plain(q, q, q, lens))
    kc = torch.from_numpy(_rand(rng, 64, 2, 32))
    qc = torch.from_numpy(_rand(rng, 16, 4, 32))
    assert torch.equal(tfa.causal_cache_flash_attention(qc, kc, kc, 0, 16),
                       tfa.causal_cache_attention_plain(qc, kc, kc, 0, 16))
    qd, kn = torch.from_numpy(_rand(rng, 4, 32)), torch.from_numpy(_rand(rng, 2, 32))
    assert torch.equal(tfa.decode_flash_attention(qd, kn, kn, kc, kc, 10),
                       tfa.decode_attention_plain(qd, kn, kn, kc, kc, 10))
    assert ffi.launch_counts == before


@pytest.mark.parametrize("start,kv_min,expect", [
    (0, 0, 0), (1, 0, 1), (37, 0, 5), (300, 0, 38), (300, 17, 36),
    (315, 0, 40), (4095, 0, 512), (100000, 0, 12500), (20, 30, 0),
])
def test_decode_splits_cover_the_live_rows(start, kv_min, expect):
    """B3's fixed grid: DECODE_MAX_BLOCKS blocks per KV head (one cluster)
    at every position, each taking `expect` = ceil(live / 8) live rows from
    kv_min on, as csrc/decode_attention.cu works them out from the position
    it reads on the device; together the blocks hold every live row once,
    and the blocks past the live rows hold none."""
    n = tfa.DECODE_MAX_BLOCKS
    live = max(start - kv_min, 0)
    chunk = -(-live // n)
    assert n == 8 and chunk == expect
    rows = [max(min(kv_min + (r + 1) * chunk, start) - (kv_min + r * chunk), 0)
            for r in range(n)]
    assert sum(rows) == live and all(x == chunk for x in rows[: live // max(chunk, 1)])


@pytest.mark.parametrize("B,T,H,KH,D,kvmins,block", [
    (2, 128, 4, 2, 64, (0, 5), 128),
    (3, 256, 16, 8, 128, (0, 17, 130), 128),
    (2, 320, 16, 8, 64, (0, 320), 64),     # -S 20 prompt cap, G 2, an all-pad row
    (3, 100, 14, 2, 64, (0, 100, 9), 128),  # G 7, an all-pad row
    (2, 96, 12, 4, 64, (0, 40), 96),       # G 3
])
def test_batched_causal_plain_matches_pallas(B, T, H, KH, D, kvmins, block):
    rng = np.random.default_rng(11)
    q = _rand(rng, B, T, H, D)
    k = _rand(rng, B, T, KH, D)
    v = _rand(rng, B, T, KH, D)
    kv_min = np.asarray(kvmins, np.int32)
    got = tfa.batched_causal_flash_attention(*map(torch.from_numpy, (q, k, v, kv_min))).numpy()
    want = jfa.batched_causal_flash_attention(*map(jnp.asarray, (q, k, v, kv_min)),
                                              gqa_groups=H // KH, block_q=block, block_k=block)
    # the left-pad rows are 0 on both sides: compare every row
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for b, lo in enumerate(kvmins):
        assert not got[b, :lo].any(), "left-pad rows must give exactly 0"


def _cache_case(rng, B, T, K, H, KH, D):
    return (_rand(rng, B, T, H, D), _rand(rng, B, T, KH, D), _rand(rng, B, T, KH, D),
            _rand(rng, B, KH, K, D), _rand(rng, B, KH, K, D))


def _both_batched_cache(q, kn, vn, kc, vc, start, kv_min, pm, rs, G, block_q=256):
    got = tfa.batched_cache_flash_attention(
        *map(torch.from_numpy, (q, kn, vn, kc, vc)), start, torch.from_numpy(kv_min),
        None if pm is None else torch.from_numpy(pm),
        rs if rs is None or np.ndim(rs) == 0 else torch.from_numpy(rs)).numpy()
    want = jfa.batched_cache_flash_attention(
        *map(jnp.asarray, (q, kn, vn, kc, vc)), jnp.int32(start), jnp.asarray(kv_min),
        prompt_max=None if pm is None else jnp.asarray(pm),
        region_start=None if rs is None else jnp.asarray(rs, jnp.int32),
        gqa_groups=G, block_q=block_q)
    return got, np.asarray(want)


@pytest.mark.parametrize("B,T,K,H,KH,D,start", [
    (2, 128, 256, 4, 2, 64, 192),    # cache part [0,192) + block
    (3, 64, 128, 4, 2, 64, 0),       # no cache (start 0): pure causal block
    (2, 192, 320, 4, 4, 64, 256),    # MHA (G=1), 64-granular sizes
    (4, 64, 384, 16, 8, 128, 0),     # serving group prefill: Gcap 4, G 2, D 128
    (3, 64, 256, 14, 2, 64, 192),    # G 7: cache part + block
    (2, 64, 128, 14, 2, 64, 0),      # G 7: serving group prefill
    (2, 64, 192, 12, 4, 64, 128),    # G 3
])
def test_batched_cache_plain_matches_pallas(B, T, K, H, KH, D, start):
    rng = np.random.default_rng(13)
    q, kn, vn, kc, vc = _cache_case(rng, B, T, K, H, KH, D)
    kv_min = np.asarray(([0, 3, 7] * 2)[:B], np.int32)
    cases = [(None, None)]
    if start > 0:
        cases += [
            (rng.integers(start // 2, start + 1, B).astype(np.int32), np.int32(K)),
            (rng.integers(1, start + 1, B).astype(np.int32),
             rng.integers(start // 2, K, B).astype(np.int32)),   # per-row region_start
        ]
    else:   # serving: per-row prompt lengths, no decode region yet
        cases += [(np.asarray(([40, 64, 17, 1] * 2)[:B], np.int32), np.int32(1 << 30))]
    for pm, rs in cases:
        got, want = _both_batched_cache(q, kn, vn, kc, vc, start, kv_min, pm, rs, H // KH)
        np.testing.assert_allclose(got, want, **TOL)


def test_batched_cache_plain_random_shape_sweep():
    """The seeded sweep of tests/test_kernels.py: random (B, T, K, H, KH, D,
    start) with random per-row kv_min / prompt_max / region_start."""
    rng = np.random.default_rng(29)
    for trial in range(6):
        B = int(rng.integers(1, 4))
        T = 64 * int(rng.integers(1, 9))
        block_q = int(rng.choice([64, 128, 256]))
        KH = int(rng.choice([1, 2, 4]))
        G = int(rng.choice([1, 2, 4]))
        H = KH * G
        D = int(rng.choice([32, 64]))
        start = 64 * int(rng.integers(0, 4))
        K = start + T + 64 * int(rng.integers(0, 3))
        q, kn, vn, kc, vc = _cache_case(rng, B, T, K, H, KH, D)
        kv_min = rng.integers(0, max(start, 1), B).astype(np.int32)
        if start > 0:
            pm = rng.integers(1, start + 1, B).astype(np.int32)
            rs = rng.integers(start // 2, K + 1, B).astype(np.int32)
        else:
            pm, rs = None, None
        got, want = _both_batched_cache(q, kn, vn, kc, vc, start, kv_min, pm, rs, G, block_q)
        np.testing.assert_allclose(got, want, **TOL,
                                   err_msg=f"trial {trial}: B={B} T={T} K={K} H={H} "
                                           f"KH={KH} D={D} start={start}")


def test_batched_cache_plain_ignores_junk_outside_the_window():
    """+-999 in every cache column outside the window (end pad, stale decode
    rows, rows at or past start_pos), and a row whose cache window is empty
    (kv_min >= start_pos): exactly the output of a clean cache."""
    rng = np.random.default_rng(31)
    B, T, K, H, KH, D, start = 3, 64, 256, 4, 2, 32, 128
    q, kn, vn, kc, vc = _cache_case(rng, B, T, K, H, KH, D)
    kv_min = np.asarray([0, 9, 130], np.int32)
    pm = np.asarray([50, 100, 128], np.int32)
    rs = np.asarray([96, 128, 120], np.int32)
    kc2, vc2 = kc.copy(), vc.copy()
    for b in range(B):
        dead = np.ones(K, bool)
        dead[kv_min[b]:start] = False
        dead[kv_min[b]:start] |= ~((np.arange(kv_min[b], start) < pm[b])
                                   | (np.arange(kv_min[b], start) >= rs[b]))
        kc2[b, :, dead] = 999.0
        vc2[b, :, dead] = -999.0
    args = (torch.from_numpy(kv_min), torch.from_numpy(pm), torch.from_numpy(rs))
    a = tfa.batched_cache_flash_attention(*map(torch.from_numpy, (q, kn, vn, kc, vc)),
                                          start, *args)
    b_ = tfa.batched_cache_flash_attention(*map(torch.from_numpy, (q, kn, vn, kc2, vc2)),
                                           start, *args)
    assert torch.equal(a, b_)
    assert torch.isfinite(a).all()
