"""The device log-mel front end of the port against the JAX package's, on the
CPU: `dft_tables`, `_upload_audio` (the f16 pack bit for bit), `log_mel_batch`
and `log_mel_torch` (1e-4 over valid columns), the gate `_use_device_mel`,
`_encode_batch_device_mel` (the encoder parity tolerance, 2e-4), and greedy
token ids through `-S`, `serve_continuous` and multistream's round
pre-encode with SMOLVISION_DEVICE_MEL=1 set on both sides.

One module-scoped pair of engines on the tiny f32 checkpoint with the full
vocabulary (every decoded id is visible text).
"""

import copy
import inspect
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from smolvision_tpu.ops import mel as jmel
from smolvision_tpu.runtime import batch_segments as jbs
from smolvision_tpu.runtime import multistream as jms
from smolvision_tpu.runtime import serving as jserving
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.config import HOP_LENGTH, N_FFT
from smolvision_tpu_torch.ops import mel as tmel
from smolvision_tpu_torch.runtime import batch_segments as tbs
from smolvision_tpu_torch.runtime import multistream as tms
from smolvision_tpu_torch.runtime import serving as tserving
from smolvision_tpu_torch.runtime.engine import Engine
from tests.workloads import serving_clips

MEL_ATOL = 1e-4
ENC_TOL = 2e-4   # tests/test_torch_batch.py's batched-encoder tolerance


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from tools.make_tiny_model import build

    d = build("tiny", str(tmp_path_factory.mktemp("frontend") / "model"), seed=5,
              dtype="f32", full_vocab=True)
    j = JEngine(d, param_dtype=jnp.float32, kv_dtype=jnp.float32)
    t = Engine(d, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu")
    for eng in (j, t):
        eng.max_tokens = 8
        eng.set_force_language("English")
    return j, t


@pytest.fixture
def device_mel(monkeypatch):
    monkeypatch.setenv("SMOLVISION_DEVICE_MEL", "1")


def _clips():
    """A regular clip, one shorter than a conv chunk (100 frames), and one
    whose padded length passes the frame cap (400 frames, n % HOP != 0):
    the truncated tail of `_upload_audio`."""
    rng = np.random.default_rng(3)
    return [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (16000 * 3 + 77, 9000, 400 * HOP_LENGTH + 50)]


def test_dft_tables_equal():
    for got, want in zip(tmel.dft_tables(), jmel.dft_tables()):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_upload_audio_matches_jax(engines):
    jeng, teng = engines
    clips = _clips()
    jbuf, jframes, jfcap = jbs._upload_audio(jeng, clips)
    up = tbs._upload_audio(teng, clips)
    assert up.buf.dtype == torch.float16
    assert np.array_equal(up.buf.numpy().view(np.uint16), np.asarray(jbuf).view(np.uint16))
    assert (up.frames, up.fcap) == (jframes, jfcap)
    padded = tmel.reflect_pad(clips[2])
    assert len(padded) > up.buf.shape[1] == up.fcap * HOP_LENGTH + N_FFT   # truncated


def test_log_mel_batch_matches_jax_and_host(engines):
    jeng, teng = engines
    clips = _clips()
    up = tbs._upload_audio(teng, clips)
    got = tmel.log_mel_batch(up.buf, torch.tensor(up.frames), up.fcap).numpy()
    want = np.asarray(jmel.log_mel_batch_jax(jnp.asarray(up.buf.numpy()),
                                             jnp.asarray(up.frames, jnp.int32), up.fcap))
    assert got.shape == want.shape == (3, 128, up.fcap)
    for b, f in enumerate(up.frames):
        assert np.abs(got[b, :, :f] - want[b, :, :f]).max() < MEL_ATOL
        # the host mel of the same f16-rounded audio
        host = tmel.log_mel(clips[b].astype(np.float16).astype(np.float32))
        assert np.abs(got[b, :, :f] - host).max() < MEL_ATOL


def test_log_mel_torch_matches_jax_and_numpy():
    """The port of tests/test_audio.py's test of `log_mel_jax` (2e-3 against
    the host mel), and 1e-4 against `log_mel_jax` itself."""
    rng = np.random.default_rng(4)
    t = np.arange(16000 * 2) / 16000
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
         + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    host = tmel.log_mel(x)
    n_frames = host.shape[1]
    cap = n_frames + 7   # a padded bucket
    buf = np.zeros(cap * HOP_LENGTH + N_FFT, np.float32)
    padded = tmel.reflect_pad(x)
    buf[: len(padded)] = padded
    got = tmel.log_mel_torch(torch.from_numpy(buf), n_frames, cap).numpy()
    want = np.asarray(jmel.log_mel_jax(jnp.asarray(buf), jnp.int32(n_frames), cap))
    assert got.shape == (128, cap)
    assert np.abs(got[:, :n_frames] - host).max() < 2e-3
    assert np.abs(got[:, :n_frames] - want[:, :n_frames]).max() < MEL_ATOL


@pytest.mark.parametrize("env", ["", "0", "1"])
def test_use_device_mel_matches_jax_gate(engines, monkeypatch, env):
    """The truth table over family, B, weights and device, the card in the
    TPU's place."""
    _, teng = engines
    monkeypatch.setenv("SMOLVISION_DEVICE_MEL", env)
    for family in ("qwen3", "q25"):
        cfg = SimpleNamespace(family=family)
        for B in (1, 2, 3, 32):
            for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
                for dev, backend in (("cuda", "tpu"), ("cpu", "cpu")):
                    monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
                    want = jbs._use_device_mel(cfg, B, jdt)
                    assert tbs._use_device_mel(cfg, B, tdt, dev) == want, \
                        (family, B, tdt, dev, env)


def test_encode_batch_device_mel_matches_jax(engines, device_mel):
    jeng, teng = engines
    clips = _clips()
    jstack, jn = jbs._encode_batch_device_mel(jeng, clips)
    teng.perf.reset()
    tstack, tn = tbs._encode_batch_device_mel(teng, clips)
    assert tn == jn and teng.perf.encodes == 1 and teng.perf.mel_ms > 0
    for b, n in enumerate(tn):
        np.testing.assert_allclose(tstack[b, :n].numpy(), np.asarray(jstack)[b, :n],
                                   rtol=ENC_TOL, atol=ENC_TOL)


def _recorded_ids(eng, run):
    """The token ids `run()` detokenizes (the rows' text tokens, in order)."""
    ids = []
    real = eng.tokenizer.decode_piece
    eng.tokenizer.decode_piece = lambda t: ids.append(int(t)) or real(t)
    try:
        texts = run()
    finally:
        del eng.tokenizer.decode_piece
    return texts, ids


def test_segments_and_serving_device_mel_tokens_match_jax(engines, device_mel, monkeypatch):
    """-S at B 3 (one length group, so both detokenize in input order) and
    serve_continuous on nine clips in 2 slots, encoded three at a time (the
    next group's upload staged while a prefill or a decode chunk runs):
    greedy token ids equal the JAX package's."""
    jeng, teng = engines
    segs = serving_clips(3, seed=21)
    want = _recorded_ids(jeng, lambda: jbs.transcribe_segments_batched(jeng, segs))
    teng.perf.reset()
    got = _recorded_ids(teng, lambda: tbs.transcribe_segments_batched(teng, segs))
    assert got == want and want[1]
    assert teng.perf.mel_ms > 0

    # nine clips in encode groups of three: the second group's upload runs
    # in the first wave prefill's shadow, the third in a decode chunk's
    clips = serving_clips(9, seed=31)
    want = _recorded_ids(jeng, lambda: jserving.serve_continuous(jeng, clips, slots=2,
                                                                  encode_group=3))
    uploads = []
    real = tbs._upload_audio

    def upload(*args):
        callers = {f.function for f in inspect.stack()}
        uploads.append((len(args[1]), "upload_more" in callers, "_replays" in callers))
        return real(*args)

    monkeypatch.setattr(tserving, "ENCODE_GROUP", 3)
    monkeypatch.setattr(tbs, "_upload_audio", upload)
    got = _recorded_ids(teng, lambda: tserving.serve_continuous(teng, clips, slots=2))
    assert got == want and want[1]
    assert uploads == [(3, False, False), (3, True, False), (3, True, True)]


def test_pre_encode_round_device_mel_matches_jax(engines, device_mel):
    """Three spans of two sessions (a full window and a tail, and a tail):
    the rows handed to begin_chunk equal the JAX package's."""
    jeng, teng = engines
    rng = np.random.default_rng(12)
    ews = 16000 * 2

    def session(n, cursor):
        audio = (rng.standard_normal(n) * 0.2).astype(np.float32)
        return SimpleNamespace(live=None, use_enc_cache=True, audio_cursor=cursor,
                               chunk_samples=16000, total_samples=n, enc_window_samples=ews,
                               enc_cache=SimpleNamespace(next_window_start=0), local_base=0,
                               local=audio, _pre_windows=None, _pre_tail=None)

    states = [session(16000 * 4, 16000 * 2 - 4000), session(16000 * 3, 8000)]
    jstates = copy.deepcopy(states)
    jms._pre_encode_round(jeng, jstates)
    assert tms._pre_encode_round(teng, states) > 0
    spans = 0
    for st, jst in zip(states, jstates):
        for ws, (rows, n) in (st._pre_windows or {}).items():
            jrows, jn = jst._pre_windows[ws]
            assert n == jn
            np.testing.assert_allclose(rows[:n].numpy(), np.asarray(jrows)[:n],
                                       rtol=ENC_TOL, atol=ENC_TOL)
            spans += 1
        key, rows, n = st._pre_tail
        jkey, jrows, jn = jst._pre_tail
        assert (key, n) == (jkey, jn)
        np.testing.assert_allclose(rows[:n].numpy(), np.asarray(jrows)[:n],
                                   rtol=ENC_TOL, atol=ENC_TOL)
        spans += 1
    assert spans == 3
