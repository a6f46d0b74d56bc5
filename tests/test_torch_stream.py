"""Streaming (--stream) in the port against the JAX package's, on the CPU.

The same audio, made from numpy seeds, streams through both packages'
StreamState with f32 weights and cache: per chunk the raw decoded tokens,
the reused prefill rows and the committed pieces must be equal, and so
must the final text, at the default 8 s encoder windows and at 1 s windows
(so windows are cached and, past 4, evicted).  The commit / rollback /
recovery state machine is also held against the JAX one on the scripted
token sequences of tests/test_stream_logic.py, and the KV-reuse prefill
against a full prefill.

A random checkpoint whose lm_head is its embedding greedy-decodes one token
over and over, which the recovery reset swallows: every chunk would commit
nothing.  `build_stream_model` unties the tiny checkpoint's lm_head, so the
streams here decode varied tokens and commit them, and the prefix
conditioning and KV reuse run on every chunk.
"""

import json
import os
from types import SimpleNamespace
from typing import List

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.config import QWEN3_ASR_06B as J_06B
from smolvision_tpu.config import TOKEN_ASR_TEXT
from smolvision_tpu.io.safetensors import MultiSafetensors, write_safetensors
from smolvision_tpu.runtime import stream as jstream
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.config import QWEN3_ASR_06B as T_06B
from smolvision_tpu_torch.runtime import prompt as tprompt
from smolvision_tpu_torch.runtime import stream as tstream
from smolvision_tpu_torch.runtime.engine import Engine

SR = 16000


def build_stream_model(model_dir: str, seed: int = 0) -> str:
    """The tiny f32 checkpoint (full vocab) with a separate random lm_head."""
    from tools.make_tiny_model import build

    build("tiny", model_dir, seed=seed, dtype="f32", full_vocab=True)
    with MultiSafetensors(model_dir) as r:
        tensors = {k: np.asarray(r.get(k)) for k in r.names()}
    embed = tensors["thinker.model.embed_tokens.weight"]
    rng = np.random.default_rng(seed + 1000)
    tensors["thinker.lm_head.weight"] = rng.normal(0, 0.1, embed.shape).astype(np.float32)
    write_safetensors(os.path.join(model_dir, "model.safetensors"), tensors)
    path = os.path.join(model_dir, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["thinker_config"]["text_config"]["tie_word_embeddings"] = False
    with open(path, "w") as f:
        json.dump(cfg, f)
    return model_dir


def speech(seconds: float, seed: int) -> np.ndarray:
    """Speech-like audio: AM tones with a pause each second, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    sig = (0.25 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
           + 0.1 * np.sin(2 * np.pi * 700 * t) * (t % 1.0 < 0.6)
           + 0.01 * rng.standard_normal(len(t)))
    return sig.astype(np.float32)


@pytest.fixture(scope="session")
def stream_model_dir(tmp_path_factory):
    return build_stream_model(str(tmp_path_factory.mktemp("models") / "tiny-untied"))


def _engines(model_dir, enc_window_sec=None, max_new=8):
    j = JEngine(model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32,
                enc_window_sec=enc_window_sec)
    t = Engine(model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
               enc_window_sec=enc_window_sec, device="cpu")
    for eng in (j, t):
        eng.stream_max_new_tokens = max_new
        eng.past_text_conditioning = True
    return j, t


@pytest.fixture(scope="module")
def engines(stream_model_dir):
    return _engines(stream_model_dir)


@pytest.fixture(scope="module")
def windowed_engines(stream_model_dir):
    """1 s encoder windows: S 13 in B1, windows cached from the second
    chunk on and evicted past 4."""
    return _engines(stream_model_dir, enc_window_sec=1.0, max_new=6)


def stream_chunks(mod, eng, samples=None, live=None):
    """Drive one stream as `_stream_impl` does; per chunk (index, reused,
    raw tokens, committed pieces so far).  Returns (chunks, text)."""
    pieces: List[bytes] = []
    eng.token_cb = pieces.append
    try:
        state = mod.StreamState(eng, samples, live)
        chunks = []
        while state.active():
            w = state.begin_chunk()
            if w is None:
                continue
            mod.run_solo_chunk(state, w)
            chunks.append((state.chunk_idx, w.reused, list(state.raw_tokens), list(pieces)))
        return chunks, state.finalize()
    finally:
        eng.token_cb = None


# ---------------------------------------------------------------------------
# host logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,want", [
    ([], (1, 0)), ([1], (1, 0)), ([1, 2, 3], (1, 0)), ([5, 1, 1, 1], (3, 1)),
    ([9, 1, 2, 1, 2, 1, 2], (3, 2)), ([1, 2, 3, 4, 5, 6, 7] * 2, (1, 0)),
    ([7, 8, 3, 3, 3, 3], (4, 1)), ([4, 5, 6, 4, 5, 6], (2, 3)),
])
def test_tail_repeat_blocks(tokens, want):
    assert tstream.tail_repeat_blocks(tokens, 6) == want
    assert jstream.tail_repeat_blocks(tokens, 6) == want


def test_stream_prompt_and_constants_match():
    for name in ("MAX_ENC_WINDOWS", "MAX_PREFIX_TOKENS", "MAX_REPEAT_TOKEN_RUN",
                 "OVERLAP_MAX_TOKENS", "OVERLAP_MIN_TOKENS", "DEGEN_MAX_PERIOD",
                 "DEGEN_MIN_REPEATS", "STALE_CHUNKS", "RESET_INTERVAL_CHUNKS",
                 "RESET_CARRY_TOKENS"):
        assert getattr(tstream, name) == getattr(jstream, name), name
    from smolvision_tpu.runtime import prompt as jprompt

    args = (39, [11, 12], [151704, TOKEN_ASR_TEXT], [TOKEN_ASR_TEXT, 5, 6])
    assert (tprompt.build_stream_prompt(T_06B, *args)
            == jprompt.build_stream_prompt(J_06B, *args))


class _Tok:
    def decode_piece(self, t: int) -> bytes:
        return f"[{t}]".encode()


class FakeEngine:
    """The surface `_stream_impl` uses, with scripted decode outputs (the
    fake of tests/test_stream_logic.py); `encode_mel` returns `array`'s
    arrays (numpy for the JAX module, torch for the port)."""

    def __init__(self, chunk_outputs, cfg, array, **settings):
        self.cfg = cfg
        self.stream_chunk_sec = 2.0
        self.stream_rollback = 2
        self.stream_unfixed_chunks = 2
        self.stream_max_new_tokens = 8
        self.past_text_conditioning = True
        self.skip_silence = False
        self.verbose = 0
        self.monitor = False
        self.max_tokens = 2048
        self.token_cb = None
        self.perf = SimpleNamespace(
            reset=lambda: None, encode_ms=0.0, decode_ms=0.0, prefill_ms=0.0, total_ms=0.0,
            text_tokens=0, audio_ms=0.0, stream_chunk_ms=[],
            stream_first_commit_ms=None, stream_latency=lambda: None)
        self._prompt_tokens: List[int] = []
        self._force_tokens: List[int] = []
        self.tokenizer = _Tok()
        self.chunk_outputs = [list(c) for c in chunk_outputs]
        self.reuse_log: List[int] = []
        self.array = array
        for k, v in settings.items():
            setattr(self, k, v)

    def prepare_prompt(self):
        pass

    def _sync(self):
        pass

    def encode_mel(self, mel):
        n = max(mel.shape[1] // 8, 1)
        return self.array(np.zeros((n, 8), dtype=np.float32)), n

    def prefill_with_reuse(self, ids, audio, audio_start, n_audio, reused, greedy=True):
        self.reuse_log.append(min(reused, len(ids) - 1))
        return 0, len(ids)

    def decode_greedy(self, first, pos, max_new, on_token):
        toks = self.chunk_outputs.pop(0) if self.chunk_outputs else []
        n = 0
        for t in toks[:max_new]:
            n += 1
            if not on_token(t):
                break
        return n


ASR = TOKEN_ASR_TEXT
SCRIPTS = {
    "cold_then_final": ([[ASR, 10, 11, 12], [ASR, 10, 11, 12, 13], [12, 13, 14]], 6.0, {}),
    "rollback": ([[ASR, 10, 11], [ASR, 10, 11, 12], [11, 12, 13, 14], [13, 14, 15]], 8.0, {}),
    "divergent": ([[ASR, 10, 11], [ASR, 10, 11, 12], [11, 12, 13, 14], [99, 13, 14, 15]],
                  8.0, {}),
    "prefix_feeds": ([[ASR, 10, 11, 12], [ASR, 10, 11, 12, 13], [12, 13, 14], [13, 14, 15]],
                     8.0, {}),
    "repeat_run_recovery": ([[ASR, 10, 11], [ASR, 10, 11, 12], [42] * 24,
                             [ASR, 20, 21, 22, 23]], 8.0, {}),
    "degenerate_tail": ([[ASR, 10, 11], [ASR, 10, 11, 12], [5, 6] * 6, [ASR, 30, 31, 32, 33]],
                        8.0, {"stream_max_new_tokens": 12}),
    "stagnant": ([[ASR, 1, 2, 3, 4, 5, 6, 7, 8]] + [[9] * 8] * 7, 16.0, {}),
    "forced_overlap": ([[1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 5, 6, 7], [4, 5, 6, 7, 8, 9, 10],
                        [3, 4, 5, 6, 7, 8, 9, 10, 11]], 8.0,
                       {"_force_tokens": [151704, ASR]}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_stream_state_matches_jax_on_scripted_tokens(name):
    chunks, seconds, settings = SCRIPTS[name]
    t = np.arange(int(SR * seconds))
    audio = (0.1 * np.sin(t / 10.0)).astype(np.float32)
    out = []
    for mod, cfg, array in ((jstream, J_06B, np.asarray), (tstream, T_06B, torch.from_numpy)):
        eng = FakeEngine(chunks, cfg, array, **settings)
        emitted = []
        eng.token_cb = emitted.append
        text = mod._stream_impl(eng, audio, None)
        out.append((text, emitted, eng.reuse_log, eng.perf.text_tokens))
    assert out[1] == out[0]
    assert out[1][2]   # chunks were prefilled


# ---------------------------------------------------------------------------
# KV-reuse prefill (kernel B2 at start_pos > 0)
# ---------------------------------------------------------------------------

def test_prefill_with_reuse_matches_full(engines):
    jeng, eng = engines
    base = [151644, 8948, 198, 151645, 198] + list(range(300, 340))
    ext = base + list(range(500, 520))

    eng.reset_kv()
    ref, _ = eng.prefill_ids(ext, None, -1, 0, greedy=False)
    ref_rows = eng._kv[:, :, : len(ext)].clone()
    eng.reset_kv()
    eng.prefill_ids(base, None, -1, 0)
    eng.perf.reset()
    got, total = eng.prefill_with_reuse(ext, None, -1, 0, reused=len(base), greedy=False)
    assert total == len(ext)
    assert (eng.perf.prefills, eng.perf.reuse_prefills) == (1, 1)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(eng._kv[:, :, : len(ext)], ref_rows, rtol=0, atol=1e-5)

    jeng.reset_kv()
    jeng.prefill_ids(base, None, -1, 0)
    want, jtotal = jeng.prefill_with_reuse(ext, None, -1, 0, reused=len(base), greedy=False)
    assert jtotal == total
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_prefill_reuse_then_decode_matches(engines):
    """Decode after a reused prefill == after a full prefill, and the JAX
    engine's; the delta crosses a 64-row bucket of its embeds."""
    jeng, eng = engines
    base = list(range(700, 760))
    ext = base + list(range(800, 812))
    got = {}
    for name, e, reuse in (("full", eng, False), ("reuse", eng, True), ("jax", jeng, True)):
        e.reset_kv()
        if reuse:
            e.prefill_ids(base, None, -1, 0)
            first, pos = e.prefill_with_reuse(ext, None, -1, 0, reused=len(base))
        else:
            first, pos = e.prefill_ids(ext, None, -1, 0)
        toks = []
        e.decode_greedy(first, pos, 6, lambda t: (toks.append(t) or True))
        got[name] = (pos, toks)
    assert got["reuse"] == got["full"] == got["jax"]


@pytest.mark.parametrize("reused", [32, 40])
def test_reuse_clamped_to_total_minus_one(engines, reused):
    """reused >= len(ids) clamps: the last row is recomputed at start 31."""
    _, eng = engines
    ids = list(range(900, 932))
    eng.reset_kv()
    want, _ = eng.prefill_ids(ids, None, -1, 0, greedy=False)
    eng.perf.reset()
    got, total = eng.prefill_with_reuse(ids, None, -1, 0, reused=reused, greedy=False)
    assert total == len(ids) and eng.perf.reuse_prefills == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_prefill_ids_at_start_pos(engines):
    """prefill_ids(start_pos > 0) takes the delta ids and keeps the rows
    below start_pos."""
    _, eng = engines
    base = list(range(100, 140))
    delta = list(range(200, 210))
    eng.reset_kv()
    want, _ = eng.prefill_ids(base + delta, None, -1, 0, greedy=False)
    eng.reset_kv()
    eng.prefill_ids(base, None, -1, 0)
    got, pos = eng.prefill_ids(delta, None, -1, 0, start_pos=len(base), greedy=False)
    assert pos == len(base) + len(delta)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# whole streams against the JAX package
# ---------------------------------------------------------------------------

def _check_stream_equal(jeng, eng, audio):
    want = stream_chunks(jstream, jeng, audio)
    eng.perf.reset()
    got = stream_chunks(tstream, eng, audio)
    assert [c[:2] for c in got[0]] == [c[:2] for c in want[0]]    # chunk, reused
    for g, w in zip(got[0], want[0]):
        assert g == w, f"chunk {g[0]}"
    assert got[1] == want[1]
    return got


def test_stream_per_chunk_matches_jax(engines):
    """6 chunks over 11 s: one 8 s window cached from the 4th chunk, the
    prefix conditioning from the 3rd; every chunk after the first reuses
    cached rows (B2 at start > 0)."""
    jeng, eng = engines
    chunks, text = _check_stream_equal(jeng, eng, speech(11.0, seed=1))
    assert len(chunks) == 6 and text
    assert all(c[1] > 0 for c in chunks[1:])
    assert eng.perf.reuse_prefills == 5
    first, p50, p99 = eng.perf.stream_latency()
    assert first is not None and 0 < p50 <= p99


def test_stream_per_chunk_matches_jax_1s_windows(windowed_engines, capfd):
    """1 s windows over 7 s: every chunk caches new windows (B1 at S 13),
    and past 4 the oldest is evicted (the monitor's ⟳)."""
    jeng, eng = windowed_engines
    assert eng.cfg.enc_n_window_infer == jeng.cfg.enc_n_window_infer == 100
    assert eng.cfg.window_token_size() == 13
    eng.monitor = True
    try:
        chunks, text = _check_stream_equal(jeng, eng, speech(7.0, seed=2))
    finally:
        eng.monitor = False
    assert "⟳" in capfd.readouterr().err
    assert len(chunks) == 4 and text


def _on_off(mod, eng, audio, monkeypatch):
    on = stream_chunks(mod, eng, audio)
    monkeypatch.setenv("QWEN_STREAM_NO_ENC_CACHE", "1")
    off = stream_chunks(mod, eng, audio)
    monkeypatch.delenv("QWEN_STREAM_NO_ENC_CACHE")
    return on, off


def _tokens(run):
    """Per chunk the raw tokens and committed pieces, and the text; not the
    reused rows, which the cache's absence changes by design."""
    chunks, text = run
    return [(c[0], c[2], c[3]) for c in chunks], text


@pytest.mark.parametrize("seconds", [3.0, 11.0])
def test_stream_cache_on_off_equal(engines, monkeypatch, seconds):
    """Encoder window cache ON and OFF give exactly the same chunks and text
    at the default 8 s windows: on 3 s no window completes; on 11 s one is
    cached from the 4th chunk and joined to the re-encoded tail."""
    _, eng = engines
    on, off = _on_off(tstream, eng, speech(seconds, seed=3), monkeypatch)
    assert _tokens(on) == _tokens(off)
    assert on[1]


def test_stream_cache_on_off_equal_1s_windows(tiny_model_dir, monkeypatch):
    """tests/test_stream.py's case: 1 s windows over 3.5 s, three windows
    cached, on the tied tiny checkpoint, in the port and the JAX package."""
    j, t = _engines(tiny_model_dir, enc_window_sec=1.0, max_new=6)
    audio = speech(3.5, seed=11)
    for mod, eng in ((jstream, j), (tstream, t)):
        on, off = _on_off(mod, eng, audio, monkeypatch)
        assert _tokens(on) == _tokens(off)


def test_stream_cache_off_matches_jax_1s_windows(windowed_engines, monkeypatch):
    """Where ON and OFF part: 1 s windows over 3.5 s on the untied
    checkpoint.  A cached window's log-mel is taken over its own span (its
    edges reflect-padded, its clamp at its own maximum), so its rows differ
    from those of one encode of the whole span, in the JAX package as in
    the port.  Each mode still equals the JAX package's, chunk by chunk."""
    jeng, eng = windowed_engines
    audio = speech(3.5, seed=3)
    jon, joff = _on_off(jstream, jeng, audio, monkeypatch)
    on, off = _on_off(tstream, eng, audio, monkeypatch)
    assert on == jon and off == joff
    assert _tokens(jon) != _tokens(joff)


def test_stream_silent_shortcircuit(engines):
    """--silent + a file: one full-context pass, the offline transcript."""
    _, eng = engines
    audio = speech(3.0, seed=4)
    eng.token_cb = None
    eng.max_tokens = 24
    eng.set_force_language("English")
    try:
        text = tstream.transcribe_stream(eng, audio)
        assert text and text == eng.transcribe_segment(audio)[0]
    finally:
        eng.max_tokens = 2048
        eng.set_force_language(None)
