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
    before = dict(tfa.launch_counts)
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
    assert tfa.launch_counts == before


@pytest.mark.parametrize("start,kv_min,expect", [
    (0, 0, (0, 0)), (1, 0, (1, 1)), (300, 0, (5, 60)), (300, 17, (5, 57)),
    (4095, 0, (64, 64)), (100000, 0, (64, 1563)),
])
def test_decode_splits_cover_the_live_rows(start, kv_min, expect):
    n, chunk = tfa.decode_splits(start, kv_min)
    assert (n, chunk) == expect
    assert n * chunk >= start - kv_min and (n == 0 or (n - 1) * chunk < start - kv_min)
