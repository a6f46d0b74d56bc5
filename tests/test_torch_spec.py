"""Speculative int8-draft decoding (--spec) in the port, mirroring tests/test_spec.py.

Every emitted token is the verify forward's greedy choice over the true
accepted prefix, so the draft decides only how many positions share one
forward: the port's spec tokens must equal its plain greedy tokens and the
JAX engine's spec tokens, exactly, on the tiny f32 checkpoint (where the
int8 draft disagrees with the verify often enough to exercise the reject
and partial-accept paths), and on the CPU also with bf16 weights.
"""

import os
import subprocess
import sys

import pytest

import jax.numpy as jnp
import torch

import smolvision_tpu_torch.runtime.engine as teng_mod
from smolvision_tpu.runtime import prompt as jprompt
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.ops.quant import QuantW
from smolvision_tpu_torch.runtime import prompt as tprompt
from smolvision_tpu_torch.runtime.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def spec_engines(tiny_model_dir):
    plain = Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                   device="cpu")
    spec = Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                  device="cpu", spec=True)
    assert spec.spec and isinstance(spec.dec_params_draft["lm_head"], QuantW)
    jspec = JEngine(tiny_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32, spec=True)
    return plain, spec, jspec


def _greedy_tokens(eng, prompt_mod, audio, max_tokens):
    enc, n_audio = eng.encode_mel(log_mel(audio))
    ids, astart = prompt_mod.build_asr_prompt(eng.cfg, n_audio, eng._prompt_tokens,
                                              eng._force_tokens, None)
    eng.reset_kv()
    first, pos = eng.prefill_ids(ids, enc, astart, n_audio)
    out = []
    n = eng.decode_greedy(first, pos, max_tokens, lambda t: (out.append(t) or True))
    return n, out


@pytest.mark.parametrize("max_tokens", [1, 5, 23, 48])
def test_spec_matches_plain_greedy_and_jax(spec_engines, speech_like_audio, max_tokens):
    plain, spec, jspec = spec_engines
    ref = _greedy_tokens(plain, tprompt, speech_like_audio, max_tokens)
    spec.perf.reset()
    got = _greedy_tokens(spec, tprompt, speech_like_audio, max_tokens)
    assert got == ref
    assert got == _greedy_tokens(jspec, jprompt, speech_like_audio, max_tokens)
    p = spec.perf
    # each verify follows SPEC_DRAFT draft steps, and the verifies emit
    # exactly the tokens the loop consumed after the prefill token: none
    # past the budget, none past an EOS
    assert p.decode_steps == teng_mod.SPEC_DRAFT * p.spec_iters
    assert p.spec_tokens == got[0] - 1
    assert (p.spec_iters > 0) == (max_tokens > 1)


@pytest.fixture(scope="module")
def bf16_spec_engines(tiny_model_dir):
    plain = Engine(tiny_model_dir, param_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                   device="cpu")
    spec = Engine(tiny_model_dir, param_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                  device="cpu", spec=True)
    jspec = JEngine(tiny_model_dir, param_dtype=jnp.bfloat16, kv_dtype=jnp.bfloat16, spec=True)
    return plain, spec, jspec


@pytest.mark.parametrize("max_tokens", [5, 23, 48])
def test_spec_bf16_matches_plain_greedy_and_jax(bf16_spec_engines, speech_like_audio,
                                                max_tokens):
    """bf16 weights and cache (the CLI's default) on the CPU: the port's
    --spec tokens equal its plain greedy tokens and the JAX engine's --spec
    tokens, through partial accepts (23 and 48 tokens take 5 and 10
    verifies).  So the port's spec loop keeps the greedy sequence as the
    reference's does; where a card run parts from it at a near tie, the
    verify forward (5 rows: B2, products of 5 rows) and the one-token step
    (B3, matrix-vector products) round their bf16 products differently,
    which the engine's --spec message says."""
    plain, spec, jspec = bf16_spec_engines
    ref = _greedy_tokens(plain, tprompt, speech_like_audio, max_tokens)
    spec.perf.reset()
    got = _greedy_tokens(spec, tprompt, speech_like_audio, max_tokens)
    assert got == ref == _greedy_tokens(jspec, jprompt, speech_like_audio, max_tokens)
    p = spec.perf
    assert p.spec_iters > 0 and p.decode_steps == teng_mod.SPEC_DRAFT * p.spec_iters
    assert p.spec_tokens == got[0] - 1


@pytest.mark.parametrize("depth", [1, 2, 7])
def test_spec_draft_depths(spec_engines, speech_like_audio, monkeypatch, depth):
    """Exactness holds at every draft depth (the depth changes only how many
    positions share one verify forward)."""
    plain, spec, _ = spec_engines
    ref = _greedy_tokens(plain, tprompt, speech_like_audio, 17)
    monkeypatch.setattr(teng_mod, "SPEC_DRAFT", depth)
    spec.perf.reset()
    assert _greedy_tokens(spec, tprompt, speech_like_audio, 17) == ref
    assert spec.perf.decode_steps == depth * spec.perf.spec_iters


def test_spec_ignored_with_q8(tiny_model_dir, capfd):
    eng = Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                 device="cpu", q8=True, spec=True)
    assert eng.q8 and not eng.spec and eng.dec_params_draft is None
    assert "--spec disabled" in capfd.readouterr().err


def _cli(module, args):
    env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                          timeout=600, env=env, cwd=REPO)


def test_cli_spec_f32_equals_plain_and_jax(tmp_path, speech_like_audio):
    """`--spec --f32` prints what plain `--f32` prints, and what the JAX CLI
    prints under `--spec --f32`, byte for byte (full-vocab checkpoint: every
    decoded id is visible text)."""
    from tests.test_torch_engine import _wav_bytes
    from tools.make_tiny_model import build

    model = build("tiny", str(tmp_path / "model"), seed=5, dtype="f32", full_vocab=True)
    wav = tmp_path / "clip.wav"
    wav.write_bytes(_wav_bytes(speech_like_audio))
    args = ["-d", model, "-i", str(wav), "--f32", "--language", "English", "--max-tokens", "8",
            "--silent"]
    plain = _cli("smolvision_tpu_torch.cli", args)
    spec = _cli("smolvision_tpu_torch.cli", args + ["--spec"])
    jspec = _cli("smolvision_tpu.cli", args + ["--spec"])
    for r in (plain, spec, jspec):
        assert r.returncode == 0, r.stderr.decode()
    assert len(spec.stdout.strip()) > 0
    assert spec.stdout == plain.stdout == jspec.stdout
