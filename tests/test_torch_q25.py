"""Qwen2.5-Omni in the port (models/q25_encoder.py, the q25 halves of
models/params.py and models/qwen3_decoder.py, Engine._encode_mel_q25, the
CLI's q25 route) against the JAX package, on the CPU.

  * config detection with and without config.json equals the JAX package's;
  * `synthetic.build("tiny-q25")` is byte-identical to the tool's;
  * `params_from_jax` on the q25 trees (a QKV bias, no q/k norms, an untied
    lm_head, the zero K bias and the bos / eos rows) equals the port's own
    loaders, leaf for leaf;
  * the conv stem and the encoder at T2 of 5 / 99 / 100 / 101 / 200 / 201
    tokens (below, at and past the 100-token window edges) and the engine's
    encode at clips of 1.9-4.06 s are within 1e-5 of the JAX ones (f32,
    the same operations in another summation order);
  * greedy thinker tokens equal the JAX engine's on text and audio;
  * the CLI's ASR route (no --thinker: the thinker with the default system
    prompt), --stream on q25 (also the thinker), and --thinker --text are
    byte-equal to the JAX CLI under --f32 at --temperature 0, and several
    -i files are refused with its message.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from smolvision_tpu.config import detect_config as j_detect
from smolvision_tpu.io.safetensors import MultiSafetensors as JReader
from smolvision_tpu.models import params as jpm
from smolvision_tpu.models import q25_encoder as jq25
from smolvision_tpu.ops.mel import log_mel as j_log_mel
from smolvision_tpu.runtime.buckets import window_bucket
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.config import detect_config
from smolvision_tpu_torch.io.safetensors import MultiSafetensors
from smolvision_tpu_torch.models import params as tpm
from smolvision_tpu_torch.models import q25_encoder as tq25
from smolvision_tpu_torch.models import qwen3_decoder as tdec
from smolvision_tpu_torch.models import synthetic
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.runtime.engine import Engine
from tests.test_torch_engine import _wav_bytes
from tests.test_torch_params import _flat
from tests.test_torch_thinker import _thinker_ids, jax_cli_batch, port_cli

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def engines(tiny_q25_model_dir):
    return (JEngine(tiny_q25_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32),
            Engine(tiny_q25_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                   device="cpu"))


@pytest.mark.parametrize("with_json", [True, False])
def test_config_detection_matches_jax(tiny_q25_model_dir, tmp_path, with_json):
    d = tmp_path / "model"
    shutil.copytree(tiny_q25_model_dir, d)
    if not with_json:
        os.remove(d / "config.json")
    got, want = detect_config(str(d)), j_detect(str(d))
    assert got.family == "q25" and got.vocab_size == 152064
    assert got.__dict__ == want.__dict__
    assert (got.tied_embeddings, got.dec_qkv_bias, got.dec_qk_norm) == (False, True, False)


@pytest.mark.parametrize("dtype,full_vocab", [("bf16", False), ("f32", True)])
def test_synthetic_q25_is_byte_identical(tmp_path, dtype, full_vocab):
    from tools.make_tiny_model import build

    a = build("tiny-q25", str(tmp_path / "tool"), seed=2, dtype=dtype, full_vocab=full_vocab)
    b = synthetic.build("tiny-q25", str(tmp_path / "port"), seed=2, dtype=dtype,
                        full_vocab=full_vocab)
    for name in ("model.safetensors", "config.json", "vocab.json", "merges.txt"):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_params_from_jax_q25_equals_own_loader(tiny_q25_model_dir, jdt, tdt):
    reader = JReader(tiny_q25_model_dir)
    jcfg = j_detect(tiny_q25_model_dir, reader)
    enc_np = jax.tree_util.tree_map(np.asarray, jpm.load_q25_encoder(reader, jcfg, jdt))
    dec_np = jax.tree_util.tree_map(np.asarray, jpm.load_decoder(reader, jcfg, jdt))
    reader.close()
    enc_a, dec_a = tpm.params_from_jax(enc_np, dec_np, "cpu", tdt)
    with MultiSafetensors(tiny_q25_model_dir) as r:
        cfg = detect_config(tiny_q25_model_dir, r)
        enc_b = tpm.load_q25_encoder(r, cfg, tdt, "cpu")
        dec_b = tpm.load_decoder(r, cfg, tdt, "cpu")
    for a_tree, b_tree in ((enc_a, enc_b), (dec_a, dec_b)):
        a, b = dict(_flat(a_tree)), dict(_flat(b_tree))
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            assert torch.equal(a[name], b[name]), name
    layers = dec_b["layers"]
    assert "q_norm" not in layers and layers["bqkv"].dtype == torch.float32
    assert dec_b["lm_head"] is not dec_b["embed"]
    assert not enc_b["layers"]["bk"].any() and enc_b["audio_bos_eos"].shape[0] == 2
    assert enc_b["proj_w"].dtype == tdt and enc_b["conv1_w"].dtype == torch.float32


@pytest.mark.parametrize("t2", [5, 99, 100, 101, 200, 201])
def test_conv_stem_and_encoder_match_jax(engines, t2):
    """A random mel of 2 T2 - 1 frames (ceil(T / 2) = T2 tokens) through the
    stem, padded to a pow2 number of 100-token windows, then the windowed
    transformer, ln_post and proj."""
    jeng, teng = engines
    cfg = teng.cfg
    mel = np.random.default_rng(t2).standard_normal((128, 2 * t2 - 1)).astype(np.float32)
    got = tq25.q25_conv_stem(teng.enc_params, torch.from_numpy(mel), cfg)
    want = np.asarray(jq25.q25_conv_stem(jeng.enc_params, jnp.asarray(mel), jeng.cfg))
    assert got.shape[0] == t2 == tq25.q25_conv_out_len(2 * t2 - 1) == jq25.q25_conv_out_len(
        2 * t2 - 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    tcap = window_bucket(t2, cfg.q25_token_window)
    x = np.zeros((tcap, want.shape[1]), np.float32)
    x[:t2] = want
    got = tq25.q25_encoder_transformer(teng.enc_params, torch.from_numpy(x), t2, cfg)
    want = np.asarray(jq25.q25_encoder_transformer(jeng.enc_params, jnp.asarray(x),
                                                   jnp.int32(t2), jeng.cfg))
    np.testing.assert_allclose(got.numpy()[:t2], want[:t2], **TOL)


def _clip(seconds: float) -> np.ndarray:
    rng = np.random.default_rng(int(seconds * 100))
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("seconds", [1.9, 2.0, 2.06, 3.94, 4.06])
def test_engine_encode_matches_jax(engines, seconds):
    """The engine's encode at window-edge durations: the bos / eos rows
    around the valid tokens, padded to bucket(n + 2, 16) rows."""
    jeng, teng = engines
    sig = _clip(seconds)
    want, n_j = jeng.encode_mel(j_log_mel(sig))
    got, n_t = teng.encode_mel(log_mel(sig))
    assert n_t == n_j and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy()[:n_t], np.asarray(want)[:n_j], **TOL)


@pytest.mark.parametrize("prompt", ["text", "audio"])
def test_greedy_thinker_tokens_match_jax(engines, prompt):
    jeng, teng = engines
    audio, text = (_clip(3.0), None) if prompt == "audio" else (None, "hello there")
    want = _thinker_ids(jeng, text=text, audio=audio, temperature=0.0, thinker_max_tokens=40)
    got = _thinker_ids(teng, text=text, audio=audio, temperature=0.0, thinker_max_tokens=40)
    assert len(got) == 40 and got == want


def test_batched_forward_refuses_q25(engines):
    _, teng = engines
    cfg = teng.cfg
    kv = tdec.make_batched_kv(cfg, 1, 64, torch.float32, "cpu")
    zeros = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="q25 checkpoints route through the thinker"):
        tdec.batched_prefill(teng.dec_params, cfg, torch.zeros(1, 8, cfg.dec_hidden), kv,
                             zeros, zeros)


@pytest.fixture(scope="module")
def visible_q25(tmp_path_factory):
    from tools.make_tiny_model import build

    d = tmp_path_factory.mktemp("q25cli")
    model = build("tiny-q25", str(d / "model"), seed=2, dtype="f32", full_vocab=True)
    wav = d / "clip.wav"
    wav.write_bytes(_wav_bytes(_clip(3.0)))
    return model, str(wav)


CLI_CASES = {
    "asr_route": ["-i", "WAV", "--temperature", "0", "--max-tokens", "16", "--silent"],
    "asr_route_streamed": ["-i", "WAV", "--temperature", "0", "--max-tokens", "16"],
    "stream": ["-i", "WAV", "--stream", "--temperature", "0", "--max-tokens", "16",
               "--silent"],
    "thinker_text": ["--thinker", "--text", "hi", "--temperature", "0", "--max-tokens", "16"],
    "several_inputs": ["-i", "WAV", "WAV"],
}


def _argv(visible, case):
    model, wav = visible
    return ["-d", model, "--f32"] + [wav if a == "WAV" else a for a in CLI_CASES[case]]


@pytest.fixture(scope="module")
def jax_cli(visible_q25):
    cases = sorted(CLI_CASES)
    return dict(zip(cases, jax_cli_batch([_argv(visible_q25, c) for c in cases])))


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_q25_stdout_byte_equal(visible_q25, jax_cli, case):
    j_rc, j_out, j_err = jax_cli[case]
    t_rc, t_out, t_err = port_cli(_argv(visible_q25, case))
    assert t_rc == j_rc, t_err
    assert t_out == j_out
    if case == "several_inputs":
        assert t_rc == 1 and t_err.strip().splitlines()[-1] == (
            "Error: multiple -i files only supported in plain Qwen3 ASR mode")
        return
    assert t_rc == 0 and len(t_out.strip()) > 0
    if case == "stream":
        # --stream on a q25 checkpoint is the thinker's run: the same text
        assert t_out == jax_cli["asr_route"][1]
