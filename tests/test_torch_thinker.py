"""The port's thinker (Engine.thinker_generate, the sampled decode loop
runtime/decode_graph.SampleLoop, the CLI's --thinker) against the JAX
package's, on the CPU, where the loop's step runs eagerly.

On the untied tiny f32 checkpoint of tests/test_torch_stream.py (full vocab,
a separate random lm_head, so greedy and sampled runs emit varied visible
tokens):
  * at top_k 1 the sampled step's draw is the argmax of the transformed
    logits, so SampleLoop must give the JAX `_sample_chunk`'s tokens one for
    one (repetition penalty 1.1 included), at max_tokens 1 / 5 / 64 / 130
    and across a cache growth (512 -> 1024 rows);
  * at the defaults the port's draw (Gumbel-max over hashed uniforms)
    repeats for one seed and differs for another; an EOS at a chunk's
    first step and at a middle step ends the run there;
  * the CLI's stdout under --f32 is byte-equal to the JAX CLI's for greedy
    --text and -i, --sampler cref, the device arm's first token,
    --max-tokens 1 / 2, the text fallback when the WAV is missing, and
    --q8 greedy; several -i files are refused with the JAX message.
The JAX CLI runs all its cases in one subprocess; the port's run in this
process.
"""

import base64
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch import cli as tcli
from smolvision_tpu_torch.runtime import decode_graph
from smolvision_tpu_torch.runtime import engine as tengine_mod
from smolvision_tpu_torch.runtime.engine import Engine
from tests.test_torch_stream import build_stream_model, speech

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("thinker")
    path = build_stream_model(str(d / "model"))
    wav = d / "clip.wav"
    from tests.test_torch_engine import _wav_bytes

    wav.write_bytes(_wav_bytes(speech(3.0, seed=7)))
    return path, str(wav)


@pytest.fixture(scope="module")
def engines(model):
    return (JEngine(model[0], param_dtype=jnp.float32, kv_dtype=jnp.float32),
            Engine(model[0], param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu"))


class _Recorder:
    """A tokenizer whose decode_piece records the ids it is given."""

    def __init__(self, tok):
        self.tok, self.ids = tok, []

    def encode(self, text):
        return self.tok.encode(text)

    def decode_piece(self, tid):
        self.ids.append(int(tid))
        return self.tok.decode_piece(tid)


def _thinker_ids(eng, text="hello there", audio=None, **settings):
    """The token ids one thinker run emits (EOS excluded)."""
    defaults = dict(temperature=0.7, repetition_penalty=1.1, top_k=40, seed=0,
                    thinker_max_tokens=2048, sampler_mode="np")
    defaults.update(settings)
    for k, v in defaults.items():
        setattr(eng, k, v)
    real = eng.tokenizer
    rec = _Recorder(real)
    eng._tokenizer = rec
    try:
        eng.thinker_generate(audio, text)
    finally:
        eng._tokenizer = real
    return rec.ids


@pytest.mark.parametrize("max_tokens", [1, 5, 64, 130])
def test_sample_loop_top_k_1_matches_jax(engines, max_tokens):
    jeng, teng = engines
    want = _thinker_ids(jeng, top_k=1, thinker_max_tokens=max_tokens)
    got = _thinker_ids(teng, top_k=1, thinker_max_tokens=max_tokens)
    assert len(got) == max_tokens
    assert got == want


def test_sample_loop_top_k_1_across_cache_growth(engines):
    """530 tokens after a prompt of about 20 rows: the cache grows from 512
    to 1024 rows mid-run, which makes a new loop; its window carries over."""
    jeng, teng = engines
    want = _thinker_ids(jeng, top_k=1, thinker_max_tokens=530)
    teng.perf.reset()
    got = _thinker_ids(teng, top_k=1, thinker_max_tokens=530)
    assert teng._kv_cap == 1024 and isinstance(teng._loop, decode_graph.SampleLoop)
    assert got == want and len(set(got)) > 10
    # one sampled step per token after the host's first, none wasted on the CPU
    assert teng.perf.decode_steps == teng.perf.logits_steps == 529
    assert teng.perf.wasted_steps == 0


def test_sampled_defaults_repeat_per_seed(engines):
    _, teng = engines
    a = _thinker_ids(teng, thinker_max_tokens=80)
    b = _thinker_ids(teng, thinker_max_tokens=80)
    c = _thinker_ids(teng, thinker_max_tokens=80, seed=1)
    assert a == b and len(a) == 80
    assert c != a


@pytest.mark.parametrize("at", ["first", "middle"])
def test_sampled_eos_ends_the_run(engines, monkeypatch, at):
    """The token drawn at a chunk's first step (index 1: the first device
    step after the host's token; or index 65, the second chunk's first) or
    at a middle step, made an EOS: the run ends before it, its draws
    before it unchanged."""
    _, teng = engines
    full = _thinker_ids(teng, thinker_max_tokens=100)
    picks = [1, 65] if at == "first" else [30]
    k = next(i for i in picks + list(range(2, 100)) if full[i] not in full[:i])
    for mod in (tengine_mod, decode_graph):
        monkeypatch.setattr(mod, "EOS_TOKEN_IDS", (full[k],))
    teng.reset_kv()
    assert _thinker_ids(teng, thinker_max_tokens=100) == full[:k]


# ---------------------------------------------------------------------------
# the CLI, byte-equal to the JAX CLI
# ---------------------------------------------------------------------------

_JAX_BATCH = r"""
import base64, contextlib, io, json, sys
from smolvision_tpu import cli
out = []
for argv in json.loads(sys.argv[1]):
    raw = io.BytesIO()
    txt = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    err = io.StringIO()
    with contextlib.redirect_stdout(txt), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
    txt.flush()
    out.append([rc, base64.b64encode(raw.getvalue()).decode(), err.getvalue()])
print("RESULT " + json.dumps(out))
"""


def jax_cli_batch(argvs):
    """The JAX CLI's (rc, stdout bytes, stderr) for each argv, all in one
    subprocess on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_BATCH, json.dumps(argvs)],
                       capture_output=True, timeout=900, env=env, cwd=REPO)
    line = next((x for x in r.stdout.decode().splitlines() if x.startswith("RESULT ")), None)
    assert line is not None, r.stderr.decode()[-3000:]
    return [(rc, base64.b64decode(out), err) for rc, out, err in json.loads(line[7:])]


def port_cli(argv):
    """The port's CLI in this process on the CPU: (rc, stdout bytes, stderr)."""
    raw = io.BytesIO()
    txt = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    err = io.StringIO()
    old = os.environ.get("SMOLVISION_PLATFORM")
    os.environ["SMOLVISION_PLATFORM"] = "cpu"
    try:
        with contextlib.redirect_stdout(txt), contextlib.redirect_stderr(err):
            rc = tcli.main(argv)
    finally:
        if old is None:
            del os.environ["SMOLVISION_PLATFORM"]
        else:
            os.environ["SMOLVISION_PLATFORM"] = old
    txt.flush()
    return rc, raw.getvalue(), err.getvalue()


CLI_CASES = {
    "greedy_text": ["--thinker", "--text", "tell me a story", "--temperature", "0",
                    "--max-tokens", "24"],
    "greedy_audio": ["--thinker", "-i", "WAV", "--temperature", "0", "--max-tokens", "24",
                     "--silent"],
    "cref_sampled": ["--thinker", "--text", "hi", "--sampler", "cref", "--max-tokens", "16",
                     "--seed", "3"],
    "device_first_token": ["--thinker", "--text", "hi", "--max-tokens", "1", "--seed", "5"],
    "max_tokens_1": ["--thinker", "--text", "hi", "--temperature", "0", "--max-tokens", "1"],
    "max_tokens_2": ["--thinker", "-i", "WAV", "--temperature", "0", "--max-tokens", "2"],
    "text_fallback": ["--thinker", "-i", "MISSING", "--text", "hi", "--temperature", "0",
                      "--max-tokens", "8"],
    "several_inputs": ["--thinker", "-i", "WAV", "WAV", "--temperature", "0"],
    "q8_greedy": ["--q8", "--thinker", "--text", "hi", "--temperature", "0",
                  "--max-tokens", "12"],
}


def _argv(model, case):
    path, wav = model
    args = [wav if a == "WAV" else (wav + ".missing" if a == "MISSING" else a)
            for a in CLI_CASES[case]]
    return ["-d", path] + args + ([] if "--q8" in args else ["--f32"])


@pytest.fixture(scope="module")
def jax_cli(model):
    cases = sorted(CLI_CASES)
    return dict(zip(cases, jax_cli_batch([_argv(model, c) for c in cases])))


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_thinker_stdout_byte_equal(model, jax_cli, case):
    j_rc, j_out, j_err = jax_cli[case]
    t_rc, t_out, t_err = port_cli(_argv(model, case))
    assert t_rc == j_rc, t_err
    assert t_out == j_out
    if case == "several_inputs":
        assert t_rc == 1 and t_err.strip().splitlines()[-1] == j_err.strip().splitlines()[-1] == (
            "Error: multiple -i files only supported in plain Qwen3 ASR mode")
    else:
        assert t_rc == 0 and len(t_out.strip()) > 0
    if case == "text_fallback":
        assert "smolvision: cannot load audio" in t_err
    if case == "max_tokens_1" or case == "device_first_token":
        assert t_out.count(b"tok") == 1
