"""Port decoder (models/qwen3_decoder.py) against the JAX prefill / decode_step
on the tiny f32 checkpoint.

f32 weights and cache on both sides; the port runs its kernels' plain
versions on the CPU.  Tolerance 2e-4 on logits and cache rows (two layers,
f32 sums in another order), and exact greedy tokens.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.config import detect_config as j_detect
from smolvision_tpu.io.safetensors import MultiSafetensors as JReader
from smolvision_tpu.models import params as jpm
from smolvision_tpu.models import qwen3_decoder as jdec
from smolvision_tpu_torch.config import detect_config
from smolvision_tpu_torch.io.safetensors import MultiSafetensors
from smolvision_tpu_torch.models import params as tpm
from smolvision_tpu_torch.models import qwen3_decoder as tdec

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def both(tiny_model_dir):
    reader = JReader(tiny_model_dir)
    jcfg = j_detect(tiny_model_dir, reader)
    jparams = jpm.load_decoder(reader, jcfg, jnp.float32)
    reader.close()
    with MultiSafetensors(tiny_model_dir) as r:
        cfg = detect_config(tiny_model_dir, r)
        tparams = tpm.load_decoder(r, cfg, torch.float32, "cpu")
    return jcfg, jparams, cfg, tparams


def test_build_embeds_splices_audio(both):
    jcfg, jparams, cfg, tparams = both
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1000, 64)
    audio = rng.standard_normal((32, cfg.dec_hidden)).astype(np.float32)
    got = tdec.build_embeds(tparams, torch.from_numpy(ids), torch.from_numpy(audio), 9, 20)
    want = jdec.build_embeds(jparams, jnp.asarray(ids, jnp.int32), jnp.asarray(audio),
                             jnp.int32(9), jnp.int32(20))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_gate_up(both):
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    for g, w in zip(tdec._split_gate_up(torch.from_numpy(x)),
                    jdec._split_gate_up(jnp.asarray(x), 1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("start", [0, 40])
def test_prefill_logits_and_cache(both, start):
    """Prefill of a 128-row bucket with 100 valid rows (start 40: on top of
    an earlier block) — logits of the last valid row and the cache rows."""
    jcfg, jparams, cfg, tparams = both
    rng = np.random.default_rng(0)
    Tcap, Kcap, valid = 128, 256, 100
    pre = rng.standard_normal((64, cfg.dec_hidden)).astype(np.float32)
    emb = rng.standard_normal((Tcap, cfg.dec_hidden)).astype(np.float32)

    kv_t = tdec.make_kv_cache(cfg, Kcap, torch.float32, "cpu")
    kv_j = jdec.make_kv_cache(jcfg, Kcap, jnp.float32)
    if start:
        _, kv_t = tdec.prefill(tparams, cfg, torch.from_numpy(pre), 0, start, kv_t)
        _, kv_j = jdec.prefill(jparams, jcfg, jnp.asarray(pre), jnp.int32(0),
                               jnp.int32(start), kv_j)
    got, kv_t = tdec.prefill(tparams, cfg, torch.from_numpy(emb), start, valid, kv_t,
                             greedy=False)
    want, kv_j = jdec.prefill(jparams, jcfg, jnp.asarray(emb), jnp.int32(start),
                              jnp.int32(valid), kv_j, greedy=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rows = slice(0, start + valid)
    np.testing.assert_allclose(kv_t.numpy()[:, :, rows], np.asarray(kv_j)[:, :, rows], **TOL)


def test_decode_steps_match(both):
    """Greedy decode_step tokens and logits after a prefill."""
    jcfg, jparams, cfg, tparams = both
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((64, cfg.dec_hidden)).astype(np.float32)
    kv_t = tdec.make_kv_cache(cfg, 256, torch.float32, "cpu")
    kv_j = jdec.make_kv_cache(jcfg, 256, jnp.float32)
    tok_t, kv_t = tdec.prefill(tparams, cfg, torch.from_numpy(emb), 0, 50, kv_t)
    tok_j, kv_j = jdec.prefill(jparams, jcfg, jnp.asarray(emb), jnp.int32(0),
                               jnp.int32(50), kv_j)
    tok_t, tok_j = int(tok_t), int(tok_j)
    for pos in range(50, 58):
        assert tok_t == tok_j
        lt, kv_t = tdec.decode_step(tparams, cfg, tok_t, pos, kv_t, greedy=False)
        lj, kv_j = jdec.decode_step(jparams, jcfg, jnp.int32(tok_j), jnp.int32(pos), kv_j,
                                    greedy=False)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tok_t, tok_j = int(torch.argmax(lt)), int(jnp.argmax(lj))
