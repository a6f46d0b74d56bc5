"""smolvision_tpu_torch.ops against smolvision_tpu.ops on the same numpy inputs (CPU)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.ops import common as jc
from smolvision_tpu.ops.quant import proj
from smolvision_tpu_torch.ops import common as tc

# Elementwise f32 ops: both sides evaluate the same formula in f32; 1e-6 is a
# few ulp at the magnitudes below (|x| < ~10), room for libm differences in
# exp/tanh/rsqrt only.
ATOL = 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(7, 48), (3, 5, 16)])
def test_rms_norm(shape):
    x, w = _x(shape), 1 + 0.1 * _x(shape[-1:], 1)
    _close(tc.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jc.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_layer_norm():
    x, w, b = _x((9, 64), scale=3.0), 1 + 0.1 * _x((64,), 1), 0.1 * _x((64,), 2)
    _close(tc.layer_norm(*map(torch.from_numpy, (x, w, b))),
           jc.layer_norm(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("fn", ["gelu_tanh", "silu"])
def test_activations(fn):
    x = _x((11, 33), scale=3.0)
    _close(getattr(tc, fn)(torch.from_numpy(x)), getattr(jc, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("length,channels", [(13, 64), (104, 896)])
def test_sinusoidal_pe(length, channels):
    np.testing.assert_array_equal(tc.sinusoidal_pe(length, channels),
                                  jc.sinusoidal_pe(length, channels))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope_tables_and_apply(head_dim):
    # positions of a prompt + decode: angles up to ~300 rad, where one f32
    # ulp of angle is ~3e-5 — keep them below 64 for the 1e-6 check
    pos = np.arange(0, 64)
    cos_t, sin_t = tc.rope_tables(torch.from_numpy(pos), head_dim, 1e6)
    cos_j, sin_j = jc.rope_tables(jnp.asarray(pos), head_dim, 1e6)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    x = _x((64, 4, head_dim))
    _close(tc.apply_rope_neox(torch.from_numpy(x), cos_t, sin_t),
           jc.apply_rope_neox(jnp.asarray(x), cos_j, sin_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_matches_proj(dtype):
    """linear = the JAX einsum with f32 accumulation; x is cast to the weight
    dtype first, as the JAX callers do.  A 96-term dot product reordered in
    f32 differs by ~1e-6 relative; 1e-5 absolute at outputs of ~10."""
    x, w, b = _x((5, 96)), _x((40, 96), 1), _x((40,), 2)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16,
                                                                     jnp.bfloat16)
    wt = torch.from_numpy(w).to(tdt)
    got = tc.linear(torch.from_numpy(x), wt, torch.from_numpy(b))
    assert got.dtype == torch.float32
    wj = jnp.asarray(w).astype(jdt)
    want = proj("th,oh->to", jnp.asarray(x).astype(jdt), wj) + jnp.asarray(b)
    _close(got, want, atol=1e-5)
