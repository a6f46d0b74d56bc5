"""Port Engine and CLI against the JAX Engine and CLI on the tiny f32 checkpoint.

Greedy token ids must be equal (the north-star check of the port), and the
two CLIs' stdout byte-equal on a full-vocab checkpoint, where every decoded
id is visible text.  --f32 keeps both sides in f32: with bf16 weights torch's
and XLA's bf16 products round at other places.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.runtime import prompt as jprompt
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.runtime import prompt as tprompt
from smolvision_tpu_torch.runtime.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    return (JEngine(tiny_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32),
            Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                   device="cpu"))


def _greedy(eng, prompt_mod, audio, n_audio, max_tokens, force=()):
    ids, audio_start = prompt_mod.build_asr_prompt(eng.cfg, n_audio, (), force)
    eng.reset_kv()
    first, pos = eng.prefill_ids(ids, audio, audio_start, n_audio)
    got = []
    n = eng.decode_greedy(first, pos, max_tokens, lambda t: got.append(t) or True)
    return got, n


def test_encode_mel_matches(engines, speech_like_audio):
    jeng, teng = engines
    mel = log_mel(speech_like_audio)  # 299 frames: 2 full chunks + a partial one
    want, n_j = jeng.encode_mel(mel)
    got, n_t = teng.encode_mel(mel)
    assert n_t == n_j == 39 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy()[:n_t], np.asarray(want)[:n_j],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("force", [(), (151704,)])
def test_greedy_token_ids_match(engines, speech_like_audio, force):
    jeng, teng = engines
    mel = log_mel(speech_like_audio)
    ja, n = jeng.encode_mel(mel)
    ta, _ = teng.encode_mel(mel)
    want, n_j = _greedy(jeng, jprompt, ja, n, 24, force)
    got, n_t = _greedy(teng, tprompt, ta, n, 24, force)
    assert len(got) > 0
    assert (got, n_t) == (want, n_j)


def test_decode_past_one_kv_bucket(engines):
    """The port grows its cache by copy during decode (512 -> 1024 rows here)
    and still emits the JAX engine's tokens."""
    jeng, teng = engines
    ids = list(range(100, 160))
    want, _ = _greedy_ids(jeng, ids, 470)
    got, _ = _greedy_ids(teng, ids, 470)
    assert teng._kv_cap == 1024
    assert got == want


def _greedy_ids(eng, ids, max_tokens):
    eng.reset_kv()
    first, pos = eng.prefill_ids(ids, None, -1, 0)
    got = []
    return got, eng.decode_greedy(first, pos, max_tokens, lambda t: got.append(t) or True)


def test_transcribe_segment_and_steps(engines, speech_like_audio):
    jeng, teng = engines
    for eng in (jeng, teng):
        eng.set_force_language("English")
        eng.max_tokens = 10
    try:
        want = jeng.transcribe_segment(speech_like_audio)
        teng.perf.reset()
        got = teng.transcribe_segment(speech_like_audio)
    finally:
        for eng in (jeng, teng):
            eng.set_force_language(None)
            eng.max_tokens = 2048
    assert got == want
    # 10 tokens seen: the prefill's first plus 9 decode steps, no wasted step
    assert teng.perf.decode_steps == 9


def _wav_bytes(samples, rate=16000):
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def visible_model(tmp_path_factory, speech_like_audio):
    from tools.make_tiny_model import build

    d = tmp_path_factory.mktemp("visible")
    model = build("tiny", str(d / "model"), seed=5, dtype="f32", full_vocab=True)
    wav = d / "clip.wav"
    wav.write_bytes(_wav_bytes(speech_like_audio))
    return model, str(wav)


def _cli(module, args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                          timeout=600, env=env, cwd=REPO)


@pytest.mark.parametrize("silent", [True, False])
def test_cli_stdout_byte_equal(visible_model, silent):
    model, wav = visible_model
    args = ["-d", model, "-i", wav, "--f32", "--language", "English", "--max-tokens", "16"]
    args += ["--silent"] if silent else []
    j = _cli("smolvision_tpu.cli", args)
    t = _cli("smolvision_tpu_torch.cli", args)
    assert j.returncode == 0, j.stderr.decode()
    assert t.returncode == 0, t.stderr.decode()
    assert len(t.stdout.strip()) > 0
    assert t.stdout == j.stdout
    if not silent:
        err = t.stderr.decode()
        assert "Inference:" in err and "text tokens" in err and "realtime)" in err


@pytest.mark.parametrize("extra,what", [
    (["--moe-offload"], "--moe-offload"), (["--moe-preload"], "--moe-preload"),
    (["--thinker"], "--thinker"),
])
def test_cli_unported_modes_exit_1(visible_model, extra, what):
    model, wav = visible_model
    extra = [wav if a == "WAV" else a for a in extra]
    r = _cli("smolvision_tpu_torch.cli", ["-d", model, "-i", wav] + extra)
    assert r.returncode == 1
    err = r.stderr.decode().strip().splitlines()
    assert len(err) == 1 and what in err[0] and "not yet ported" in err[0]
    assert r.stdout == b""


def test_cli_multistream_without_card_exits_1(visible_model):
    """--stream with several -i files without a card, and without
    SMOLVISION_PLATFORM=cpu: one line naming the switch, exit 1, nothing on
    stdout (no quiet fall back to the CPU)."""
    model, wav = visible_model
    env = {k: v for k, v in os.environ.items() if k != "SMOLVISION_PLATFORM"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "smolvision_tpu_torch.cli", "-d", model, "-i", wav,
                        wav, "--stream"], capture_output=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 1 and r.stdout == b""
    assert "SMOLVISION_PLATFORM=cpu" in r.stderr.decode()


def test_cli_bad_input_one_line(visible_model, tmp_path):
    model, _ = visible_model
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    r = _cli("smolvision_tpu_torch.cli", ["-d", model, "-i", str(bad), "--silent"])
    assert r.returncode == 1
    assert r.stderr.decode().startswith("smolvision: cannot load audio")


@pytest.fixture(scope="module")
def stream_model(tmp_path_factory):
    """The untied tiny checkpoint of tests/test_torch_stream.py (its streams
    commit text) and an 11 s clip: 6 chunks, one 8 s window cached."""
    from tests.test_torch_stream import build_stream_model, speech

    d = tmp_path_factory.mktemp("stream")
    model = build_stream_model(str(d / "model"))
    wav = d / "clip.wav"
    wav.write_bytes(_wav_bytes(speech(11.0, seed=1)))
    return model, str(wav)


def _both_cli(args, stdin=None):
    out = []
    for module in ("smolvision_tpu.cli", "smolvision_tpu_torch.cli"):
        env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu")
        r = subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                           timeout=600, env=env, cwd=REPO, input=stdin)
        assert r.returncode == 0, r.stderr.decode()
        out.append(r)
    return out


@pytest.mark.parametrize("silent", [True, False])
def test_cli_stream_stdout_byte_equal(stream_model, silent):
    """--stream --f32: streamed commits (or, under --silent, the one
    full-context pass) byte-equal to the JAX CLI's."""
    model, wav = stream_model
    args = ["-d", model, "-i", wav, "--stream", "--f32", "--language", "English",
            "--max-tokens", "24"] + (["--silent"] if silent else ["--debug"])
    j, t = _both_cli(args)
    assert len(t.stdout.strip()) > 0
    assert t.stdout == j.stdout
    if not silent:
        err = t.stderr.decode()
        assert "Prefill reuse:" in err and "Stream latency:" in err and "realtime)" in err


def test_cli_stdin_stream_stdout_byte_equal(stream_model):
    """--stdin --stream: the WAV piped into both CLIs, read live."""
    model, wav = stream_model
    with open(wav, "rb") as f:
        data = f.read()
    args = ["-d", model, "--stdin", "--stream", "--f32", "--enc-window-sec", "1",
            "--stream-max-new-tokens", "8"]
    j, t = _both_cli(args, stdin=data)
    assert len(t.stdout.strip()) > 0
    assert t.stdout == j.stdout


@pytest.mark.parametrize("mode", ["offline", "stream"])
def test_cli_enc_window_sec_byte_equal(stream_model, mode):
    """--enc-window-sec 2: 26-token encoder windows (B1 at S 26)."""
    model, wav = stream_model
    args = ["-d", model, "-i", wav, "--f32", "--language", "English", "--max-tokens", "16",
            "--enc-window-sec", "2"] + (["--stream"] if mode == "stream" else ["--silent"])
    j, t = _both_cli(args)
    assert len(t.stdout.strip()) > 0
    assert t.stdout == j.stdout


@pytest.mark.parametrize("value", ["0.5", "12"])
def test_cli_enc_window_sec_out_of_range(visible_model, value):
    model, wav = visible_model
    r = _cli("smolvision_tpu_torch.cli", ["-d", model, "-i", wav, "--enc-window-sec", value])
    assert r.returncode == 1 and r.stdout == b""
    assert r.stderr.decode().strip() == f"Error: --enc-window-sec must be in [1, 8], got {float(value)}"


def test_cli_profile_writes_trace(visible_model, tmp_path):
    """--profile DIR: a torch.profiler trace in DIR, stdout unchanged."""
    model, wav = visible_model
    args = ["-d", model, "-i", wav, "--f32", "--language", "English", "--max-tokens", "8"]
    plain = _cli("smolvision_tpu_torch.cli", args)
    r = _cli("smolvision_tpu_torch.cli", args + ["--profile", str(tmp_path / "prof")])
    assert plain.returncode == r.returncode == 0, r.stderr.decode()
    assert r.stdout == plain.stdout and len(r.stdout.strip()) > 0
    assert f"profile trace written to {tmp_path / 'prof'}" in r.stderr.decode()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
