"""The port's samplers (smolvision_tpu_torch/runtime/sampling.py) against the
JAX package's.

  * `transform_logits` (torch) against `transform_logits_jnp` and the host
    `Sampler.transform` over the grid of tests/test_sampling_pin.py and at
    window overflow: both are f32 with the same operations in the same
    order, so 1e-6 relative;
  * `Drand48` bit-exact against libc's drand48;
  * `Sampler` and `CRefSampler` draw the JAX package's tokens from the same
    logits and seed (both are numpy / libm: exact);
  * the device step's draw (`draw`): its 32-bit hash is exact integer
    arithmetic, its uniforms lie in (0, 1) and do not depend on the calls
    before, and its Gumbel-max draws follow softmax(logits).
"""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smolvision_tpu.runtime import sampling as jsampling
from smolvision_tpu_torch.runtime import sampling as tsampling

V = 512
REP = tsampling.REP_WINDOW
RTOL = 1e-6


def _ring(recent_tokens):
    """The device ring buffer of a window (its last REP tokens, in ring
    order) and the count observed."""
    ring = np.zeros(REP, np.int32)
    for i, t in enumerate(recent_tokens):
        ring[i % REP] = t
    return ring, len(recent_tokens)


def _both(logits, recent_tokens, penalty, temp, top_k):
    ring, n = _ring(recent_tokens)
    j = np.asarray(jsampling.transform_logits_jnp(
        jnp.asarray(logits), jnp.asarray(ring), jnp.int32(n), jnp.float32(penalty),
        jnp.float32(temp), top_k), np.float32)
    t = tsampling.transform_logits(torch.from_numpy(logits), torch.from_numpy(ring),
                                   torch.tensor([n]), penalty, temp, top_k).numpy()
    return j, t


def _host(logits, recent_tokens, penalty, temp, top_k):
    s = tsampling.Sampler(temperature=temp, repetition_penalty=penalty, top_k=top_k)
    for t in recent_tokens:
        s.observe(t)
    return s.transform(logits)


def _assert_same(got, want):
    live = want > -1e29
    assert (live == (got > -1e29)).all()
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=0)


@pytest.mark.parametrize("temp", [0.7, 1.0, 1.3])
@pytest.mark.parametrize("penalty", [1.0, 1.1, 1.5])
@pytest.mark.parametrize("top_k", [0, 40])
def test_transform_logits_matches_jax_and_host(temp, penalty, top_k):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal(V) * 3).astype(np.float32)
    recent = [5, 5, 5, 17, 400, 401, 402, 17]
    j, t = _both(logits, recent, penalty, temp, top_k)
    _assert_same(t, j)
    _assert_same(t, _host(logits, recent, penalty, temp, top_k))


@pytest.mark.parametrize("n_seen", [REP, REP + 1, 3 * REP + 5])
def test_transform_logits_window_overflow(n_seen):
    """Past REP observations the ring wraps: the oldest tokens stop being
    penalised, as in the JAX device transform and the host window."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal(V) * 2).astype(np.float32)
    recent = [9] * 10 + [int(x) for x in rng.integers(0, V, n_seen - 10)]
    j, t = _both(logits, recent, 1.3, 1.0, 0)
    _assert_same(t, j)
    _assert_same(t, _host(logits, recent, 1.3, 1.0, 0))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1, -7])
def test_drand48_bit_exact_vs_libc(seed):
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    libc.drand48.restype = ctypes.c_double
    libc.srand48.argtypes = [ctypes.c_long]
    libc.srand48(ctypes.c_long(seed))
    ours = tsampling.Drand48(seed)
    for _ in range(1000):
        assert ours.random() == libc.drand48()


def test_libc_expf_is_libm_expf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.expf.restype = ctypes.c_float
    libm.expf.argtypes = [ctypes.c_float]
    xs = np.random.default_rng(0).uniform(-100, 1, 4000).astype(np.float32)
    want = np.array([libm.expf(float(x)) for x in xs], np.float32)
    assert np.array_equal(tsampling._libc_expf(xs), want)


@pytest.mark.parametrize("cls", ["Sampler", "CRefSampler"])
@pytest.mark.parametrize("seed,temp,penalty,top_k", [(0, 0.7, 1.1, 40), (3, 1.0, 1.5, 0),
                                                     (11, 1.3, 1.0, 5)])
def test_samplers_draw_the_jax_tokens(cls, seed, temp, penalty, top_k):
    """20 draws, each observed, from the same logits table and seed: the
    port's and the JAX package's host samplers give the same tokens."""
    rng = np.random.default_rng(seed + 100)
    table = (rng.standard_normal((20, 4096)) * 3).astype(np.float32)
    j = getattr(jsampling, cls)(temp, penalty, top_k, seed)
    t = getattr(tsampling, cls)(temp, penalty, top_k, seed)
    got, want = [], []
    for row in table:
        for s, out in ((j, want), (t, got)):
            tok = s.sample(row)
            s.observe(tok)
            out.append(tok)
    assert got == want


def test_mul32_and_hash_are_exact():
    """The 32-bit multiply behind the draw's hash equals Python's (x * c) mod
    2^32 at the extremes, and the uniforms lie in (0, 1), depend only on
    (seed, row, index) and differ between rows and seeds."""
    xs = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 123456789], dtype=torch.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 1, 0xFFFFFFFF):
        got = tsampling._mul32(xs, c).tolist()
        assert got == [(int(x) * c) % 2**32 for x in xs.tolist()]
    u = tsampling.draw_uniforms(7, torch.tensor([300]), 151936, "cpu")
    assert u.dtype == torch.float32 and float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert torch.equal(u, tsampling.draw_uniforms(7, 300, 151936, "cpu"))
    assert not torch.equal(u, tsampling.draw_uniforms(7, 301, 151936, "cpu"))
    assert not torch.equal(u, tsampling.draw_uniforms(8, 300, 151936, "cpu"))
    assert abs(float(u.mean()) - 0.5) < 0.01
    # the extremes of the hash map inside (0, 1), so the noise stays finite
    top = ((torch.tensor([2**32 - 1, 0]) >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    assert float(top[0]) < 1.0 and float(top[1]) > 0.0
    assert torch.isfinite(-torch.log(-torch.log(top))).all()


def test_gumbel_draw_follows_softmax():
    """Draws at 4000 rows from one set of logits: each token's frequency
    within 5 standard errors of its softmax probability, and a top-k
    masked token never drawn."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -1e30])
    probs = torch.softmax(logits, 0).numpy()
    n = 4000
    draws = [int(tsampling.draw(logits, 5, row)) for row in range(n)]
    freq = np.bincount(draws, minlength=6) / n
    assert freq[5] == 0
    se = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(freq - probs) <= 5 * se + 1e-9).all(), (freq, probs)
