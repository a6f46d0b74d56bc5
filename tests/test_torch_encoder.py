"""Port encoder (models/qwen3_encoder.py) against the JAX encoder on the tiny
f32 checkpoint and the same mel.

The JAX side runs with its Pallas window kernel (interpret mode,
SMOLVISION_PALLAS=1) and with its fused-XLA attention (=0), as
tests/test_pallas_paths.py does.  Tolerance 2e-4: f32 on both sides, two
stacked layers whose matmul and softmax sums run in another order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.config import detect_config as j_detect
from smolvision_tpu.io.safetensors import MultiSafetensors as JReader
from smolvision_tpu.models import params as jpm
from smolvision_tpu.models import qwen3_encoder as jenc
from smolvision_tpu.ops.mel import log_mel as j_log_mel
from smolvision_tpu_torch.config import detect_config
from smolvision_tpu_torch.io.safetensors import MultiSafetensors
from smolvision_tpu_torch.models import params as tpm
from smolvision_tpu_torch.models import qwen3_encoder as tenc
from smolvision_tpu_torch.ops.mel import log_mel

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def both(tiny_model_dir):
    reader = JReader(tiny_model_dir)
    jcfg = j_detect(tiny_model_dir, reader)
    jparams = jpm.load_qwen3_encoder(reader, jcfg, jnp.float32)
    reader.close()
    with MultiSafetensors(tiny_model_dir) as r:
        cfg = detect_config(tiny_model_dir, r)
        tparams = tpm.load_qwen3_encoder(r, cfg, torch.float32, "cpu")
    return jcfg, jparams, cfg, tparams


def test_log_mel_is_the_same(speech_like_audio):
    np.testing.assert_array_equal(log_mel(speech_like_audio), j_log_mel(speech_like_audio))


@pytest.mark.parametrize("width", [100, 99, 37, 1])
def test_conv_stem_full_and_partial_chunks(both, speech_like_audio, width):
    """Full chunks batched; a partial tail chunk at its true width."""
    jcfg, jparams, cfg, tparams = both
    mel = log_mel(speech_like_audio)
    n = 2 if width == 100 else 1
    chunks = np.stack([mel[:, c * 100 : c * 100 + width] for c in range(n)]).astype(np.float32)
    got = tenc.conv_stem(tparams, torch.from_numpy(chunks), cfg).numpy()
    want = np.asarray(jenc.conv_stem(jparams, jnp.asarray(chunks), jcfg))
    assert got.shape == want.shape == (n, tenc.partial_chunk_tokens(width), cfg.enc_d_model)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pallas", ["1", "0"])
@pytest.mark.parametrize("valid", [26, 117])
def test_encoder_transformer_matches_jax(both, speech_like_audio, pallas, valid, monkeypatch):
    """valid 26: one window with pad keys; valid 117: a full window plus a
    partial one, W = 2."""
    jcfg, jparams, cfg, tparams = both
    wts = cfg.window_token_size()
    tcap = -(-valid // wts) * wts
    x = np.random.default_rng(3).standard_normal((tcap, cfg.enc_d_model)).astype(np.float32)
    got = tenc.encoder_transformer(tparams, torch.from_numpy(x), valid, cfg, wts).numpy()
    monkeypatch.setenv("SMOLVISION_PALLAS", pallas)
    want = np.asarray(jenc.encoder_transformer(jparams, jnp.asarray(x), jnp.int32(valid),
                                               jcfg, wts))
    np.testing.assert_allclose(got[:valid], want[:valid], **TOL)


@pytest.mark.parametrize("frames", [100, 200, 101, 199, 299, 2000])
def test_total_encoder_tokens(both, frames):
    jcfg, _, cfg, _ = both
    assert tenc.total_encoder_tokens(frames, cfg) == jenc.total_encoder_tokens(frames, jcfg)
