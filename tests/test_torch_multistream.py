"""Multistream (--stream with several -i files) in the port against the JAX
package's, on the CPU.

The same seeded clips stream through both packages' coordinators
(`run_streams_batched` / `run_streams`) on the untied tiny f32 checkpoint
of tests/test_torch_stream.py (its streams commit text).  Per session and
per chunk, the raw decoded tokens, the reused prefill rows and the
committed pieces must equal the JAX package's exactly, and the tokens and
pieces must equal the port's own solo stream of the same clip.  Cases: 3
and 8 sessions, reuse off, encoder-window eviction (1 s windows), deep
compaction (8 sessions draining to 1), --q8 weights, live sources polled
on the coordinator (trickled against fully buffered), a one-session round
through the batched path against the single-stream fallback, the batched
mode against the threaded one, and the stratified reset-row prefill
(SMOLVISION_MSTREAM_STRAT=1) in the JAX package's three arms.  The port's
round prefill runs at a device start here too (the graph's eager form).  Then `quantize_block` and
`kv_rows_gather` against the JAX ones, and the CLI's stdout.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.io.live import LiveAudio as JLiveAudio
from smolvision_tpu.ops import quant as jquant
from smolvision_tpu.runtime import multistream as jms
from smolvision_tpu.runtime import stream as jstream
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.io.live import LiveAudio
from smolvision_tpu_torch.ops import quant as tquant
from smolvision_tpu_torch.runtime import multistream as tms
from smolvision_tpu_torch.runtime import stream as tstream
from smolvision_tpu_torch.runtime.engine import Engine
from tests.test_torch_stream import build_stream_model, speech

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
PKGS = {"jax": (jms, jstream), "torch": (tms, tstream)}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return build_stream_model(str(tmp_path_factory.mktemp("models") / "tiny-untied"))


def _engines(model_dir, **kwargs):
    j = JEngine(model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32, **kwargs)
    t = Engine(model_dir, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu",
               **kwargs)
    for eng in (j, t):
        eng.stream_max_new_tokens = 6
        eng.max_tokens = 16
        eng.past_text_conditioning = True
    return {"jax": j, "torch": t}


@pytest.fixture(scope="module")
def engines(model_dir):
    return _engines(model_dir)


@pytest.fixture(scope="module")
def engines_2s(model_dir):
    """2 s encoder windows (26 rows): reuse passes 64 rows by the third."""
    return _engines(model_dir, enc_window_sec=2.0)


def clips(seconds, seed=0):
    return [speech(float(s), seed=seed + i) for i, s in enumerate(seconds)]


class Recorder:
    """Per session (in the order the sessions' engine views are made) its
    chunks: (chunk index, reused rows, raw tokens, committed pieces so far),
    taken after each finish_chunk of either package."""

    def __init__(self, monkeypatch):
        self.views, self.log = [], []
        for ms_mod, st_mod in PKGS.values():
            clone, finish = ms_mod.clone_session, st_mod.StreamState.finish_chunk

            def spy_clone(engine, _clone=clone):
                view = _clone(engine)
                self.views.append(view)
                return view

            def spy_finish(state, w, *args, _finish=finish):
                _finish(state, w, *args)
                self.log.append((state.engine, (state.chunk_idx - 1, w.reused,
                                                list(state.raw_tokens),
                                                list(state.result_pieces))))

            monkeypatch.setattr(ms_mod, "clone_session", spy_clone)
            monkeypatch.setattr(st_mod.StreamState, "finish_chunk", spy_finish)

    def run(self, fn):
        """fn() -> texts; returns (texts, per-session chunk lists)."""
        self.views.clear()
        self.log.clear()
        texts = fn()
        per = [[c for v, c in self.log if v is view] for view in self.views]
        return texts, per


def batched(pkg, eng, sources):
    return PKGS[pkg][0].run_streams_batched(eng, sources)


def solo_runs(rec, eng, sources):
    """The port's single-stream run of each source, on a fresh session view."""
    out = []
    for src in sources:
        def one():
            view = tms.clone_session(eng)
            view.token_cb = lambda piece: None
            return [tstream.transcribe_stream(view, src)]
        texts, per = rec.run(one)
        out.append((texts[0], per[0]))
    return [t for t, _ in out], [p for _, p in out]


def tokens_and_pieces(per):
    return [[(c[0], c[2], c[3]) for c in chunks] for chunks in per]


def check_against_jax_and_solo(monkeypatch, engs, sources, run=batched, solo=None):
    """The port's coordinator against the JAX package's (every field) and
    against the port's solo streams (tokens and pieces; `solo`: their
    (texts, per-session chunks) if already run); returns the port's
    (texts, per-session chunks)."""
    rec = Recorder(monkeypatch)
    want = rec.run(lambda: run("jax", engs["jax"], sources))
    got = rec.run(lambda: run("torch", engs["torch"], sources))
    assert len(got[1]) == len(sources)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert g == w, f"session {i}: port {g} vs JAX {w}"
    assert got[0] == want[0]
    solo_texts, solo = solo if solo is not None else solo_runs(rec, engs["torch"], sources)
    assert tokens_and_pieces(got[1]) == tokens_and_pieces(solo)
    assert got[0] == solo_texts
    return got


def nonvacuous(per, texts):
    assert any(any(c[2] for c in chunks) for chunks in per), "no tokens decoded"
    assert any(texts), "no session committed text"


# ---------------------------------------------------------------------------
# whole runs against the JAX package and the port's solo streams
# ---------------------------------------------------------------------------

def test_three_sessions_match_jax_and_solo(engines, monkeypatch):
    """3, 4 and 5 s: sessions drain at different rounds (pad rows, then a
    one-session round through the batched path)."""
    texts, per = check_against_jax_and_solo(monkeypatch, engines, clips((3, 4, 5), seed=1))
    nonvacuous(per, texts)
    rounds = engines["torch"].perf.multistream["rounds"]
    assert [r["active"] for r in rounds] == [3, 3, 1]
    assert any(c[1] > 0 for chunks in per for c in chunks[1:]), "no row reused its cache"


def test_eight_sessions_match_jax_and_solo(engines, monkeypatch):
    """8 sessions of 3-6 s (B 8, then compacted to 4)."""
    texts, per = check_against_jax_and_solo(monkeypatch, engines,
                                            clips((3, 4, 5, 6, 3, 4, 5, 6), seed=10))
    nonvacuous(per, texts)
    record = engines["torch"].perf.multistream
    assert record["rounds"][0]["B"] == 8 and record["compactions"] >= 1


def test_no_reuse_matches_reuse_and_jax(engines, monkeypatch):
    """SMOLVISION_MSTREAM_NO_REUSE=1: a full prefill every round (S 0),
    the same tokens as with reuse, and the JAX package's chunks."""
    sources = clips((3, 4, 5), seed=1)
    rec = Recorder(monkeypatch)
    reuse = rec.run(lambda: batched("torch", engines["torch"], sources))
    monkeypatch.setenv("SMOLVISION_MSTREAM_NO_REUSE", "1")
    texts, per = check_against_jax_and_solo(monkeypatch, engines, sources)
    assert tokens_and_pieces(per) == tokens_and_pieces(reuse[1]) and texts == reuse[0]
    assert all(c[1] == 0 for chunks in per for c in chunks)
    assert all(r["S"] == 0 for r in engines["torch"].perf.multistream["rounds"])


def test_eviction_matches_jax_and_solo(model_dir, monkeypatch):
    """1 s encoder windows on 6 and 8 s: windows cached every chunk and
    evicted past 4, so a round's reuse collapses to the prompt header
    (JAX tests/test_multistream.py's eviction case)."""
    engs = _engines(model_dir, enc_window_sec=1.0)
    texts, per = check_against_jax_and_solo(monkeypatch, engs, clips((6, 8), seed=33))
    nonvacuous(per, texts)


def test_cache_half_of_b5_matches_jax_and_solo(engines_2s, monkeypatch):
    """2 s encoder windows (26 rows) on 9 and 11 s: once three windows are
    cached every row reuses 87 rows or more, so the round's delta block
    starts at S 64 (the cache half of B5's contract: per-row prompt_max,
    region_start = pcap); the prompt cap grows 128 -> 256 mid-run (the
    cache grown in place of a new one) and an eviction resets one row."""
    engs = engines_2s
    texts, per = check_against_jax_and_solo(monkeypatch, engs, clips((9, 11), seed=60))
    nonvacuous(per, texts)
    record = engs["torch"].perf.multistream
    assert [r["S"] for r in record["rounds"]].count(64) >= 2, record["rounds"]
    assert record["grows"] == 1 and record["caches"] == 2
    for r in record["rounds"]:   # the per-row prompt_max each round gave B5
        assert len(r["prompt_max"]) == r["B"]
        assert sorted(p for p in r["prompt_max"] if p) == sorted(r["lens"])
        assert r["S"] <= min(r["lens"])


def test_bf16_sessions_match_jax_and_their_solo_streams(model_dir, monkeypatch):
    """bf16 weights and cache (the CLI's default), 2 s encoder windows, 5 / 7
    / 9 s: rounds at S 0 (B5 at start 0 on a 4-row cache) and at S 64 (B5's
    cache half, after a compaction to 2 rows).  Per session and chunk the
    port's coordinator equals the JAX package's (every field), and each
    package's batched run equals its own solo streams (tokens and pieces):
    on the CPU, where every attention is its plain f32 version over the
    bf16 cache, nothing parts.  A card run whose sessions part from their
    solo streams on bf16 owes it to the kernels' rounding (B5 and the
    batched step against B2 / B3), not to the coordinator."""
    engs = {"jax": JEngine(model_dir, param_dtype=jnp.bfloat16, kv_dtype=jnp.bfloat16,
                           enc_window_sec=2.0),
            "torch": Engine(model_dir, param_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                            device="cpu", enc_window_sec=2.0)}
    for eng in engs.values():
        eng.stream_max_new_tokens = 6
        eng.max_tokens = 16
        eng.past_text_conditioning = True
    sources = clips((5, 7, 9), seed=60)
    texts, per = check_against_jax_and_solo(monkeypatch, engs, sources)
    nonvacuous(per, texts)
    rounds = engs["torch"].perf.multistream["rounds"]
    assert [r["S"] for r in rounds] == [0, 0, 0, 64, 64], rounds
    assert [r["B"] for r in rounds] == [4, 4, 4, 2, 2], rounds
    rec = Recorder(monkeypatch)
    jbatched = rec.run(lambda: batched("jax", engs["jax"], sources))
    jsolo = []
    for src in sources:
        def one(src=src):
            view = jms.clone_session(engs["jax"])
            view.token_cb = lambda piece: None
            return [jstream.transcribe_stream(view, src)]
        jsolo.append(rec.run(one))
    assert tokens_and_pieces(jbatched[1]) == tokens_and_pieces([p[0] for _, p in jsolo])
    assert jbatched[0] == [t[0] for t, _ in jsolo] == texts


def test_deep_compaction_matches_jax_and_solo(engines, monkeypatch):
    """8 sessions draining to 1 (four end after 1 chunk, two after 2, one
    after 3, one after 4): compactions 8 -> 4 -> 2, the cache re-gathered
    each time."""
    texts, per = check_against_jax_and_solo(monkeypatch, engines,
                                            clips((2, 2, 2, 2, 4, 4, 6, 8), seed=40))
    nonvacuous(per, texts)
    record = engines["torch"].perf.multistream
    assert [r["B"] for r in record["rounds"]] == [8, 4, 2, 2]
    assert [r["active"] for r in record["rounds"]] == [8, 4, 2, 1]
    assert record["compactions"] == 2 and record["caches"] >= 3


def test_q8_matches_jax_and_solo(model_dir, monkeypatch):
    """int8 decoder weights through every coordinator path."""
    engs = _engines(model_dir, q8=True)
    texts, per = check_against_jax_and_solo(monkeypatch, engs, clips((3, 4, 5), seed=1))
    nonvacuous(per, texts)


def _live_sources(cls, sources, trickle: bool):
    """LiveAudio per source: fully buffered with EOF set, or (trickle) fed
    0.5 s per session every 20 ms by a thread, each EOF set after its last
    piece; returns (lives, thread)."""
    lives = [cls() for _ in sources]
    if not trickle:
        for lv, c in zip(lives, sources):
            lv._append(np.asarray(c, np.float32))
            lv._set_eof()
        return lives, None

    def feed():
        pos = [0] * len(sources)
        while any(p < len(c) for p, c in zip(pos, sources)):
            for i, c in enumerate(sources):
                if pos[i] < len(c):
                    lives[i]._append(np.asarray(c[pos[i] : pos[i] + SR // 2], np.float32))
                    pos[i] += SR // 2
                    if pos[i] >= len(c):
                        lives[i]._set_eof()
            time.sleep(0.02)

    thread = threading.Thread(target=feed, daemon=True)
    thread.start()
    return lives, thread


def test_live_sources_on_the_coordinator(engines, monkeypatch):
    """Live sources polled on the shared clock (`nowait`): fully buffered
    they give the JAX package's chunks; trickled 0.5 s at a time (sessions
    report NOT_READY and skip rounds) they give the same tokens and pieces
    per chunk and the same texts, and so do preloaded arrays.  The clips
    are an odd number of seconds: a last chunk that ended exactly at the
    buffered audio could run before its EOF arrived and then not be final,
    which is the live semantics, not a fault."""
    sources = clips((3, 5, 7), seed=1)
    live_classes = {"jax": JLiveAudio, "torch": LiveAudio}

    def live_run(pkg, eng, srcs, trickle=False):
        lives, thread = _live_sources(live_classes[pkg], srcs, trickle)
        texts = PKGS[pkg][0].run_streams(eng, lives)
        if thread is not None:
            thread.join(timeout=30)
            assert not thread.is_alive()
        return texts

    texts, per = check_against_jax_and_solo(monkeypatch, engines, sources, run=live_run)
    nonvacuous(per, texts)
    rec = Recorder(monkeypatch)
    trickled = rec.run(lambda: live_run("torch", engines["torch"], sources, trickle=True))
    preloaded = rec.run(lambda: batched("torch", engines["torch"], sources))
    assert tokens_and_pieces(trickled[1]) == tokens_and_pieces(per) == \
        tokens_and_pieces(preloaded[1])
    assert trickled[0] == texts == preloaded[0]


def test_singleton_batched_matches_solo_fallback(engines, monkeypatch):
    """A round with one session: through the batched path (the default)
    and through the single-stream path (SMOLVISION_MSTREAM_SOLO_BATCHED=0,
    whose first solo round resets the view's cache) give the same tokens;
    the fallback equals the JAX package's fallback chunk for chunk."""
    sources = clips((3, 4, 5), seed=1)
    solo_called = []
    run_solo = tstream.run_solo_chunk
    monkeypatch.setattr(tstream, "run_solo_chunk",
                        lambda st, w: solo_called.append(1) or run_solo(st, w))
    rec = Recorder(monkeypatch)
    default = rec.run(lambda: batched("torch", engines["torch"], sources))
    assert not solo_called, "the default routed a round to the single-stream path"
    monkeypatch.setenv("SMOLVISION_MSTREAM_SOLO_BATCHED", "0")
    texts, per = check_against_jax_and_solo(monkeypatch, engines, sources)
    assert solo_called, "no one-session round: the comparison would be vacuous"
    assert tokens_and_pieces(per) == tokens_and_pieces(default[1]) and texts == default[0]


def test_batched_matches_threaded(engines, monkeypatch):
    """SMOLVISION_BATCH_STREAMS=0: one thread per session on the
    single-stream path; the same tokens and texts as the batched mode,
    every field of the solo streams (the same computation), and the same
    again from live sources.  A session settles its device spans holding
    the turn (the settle waits on events, which another session's graph
    capture refuses)."""
    sources = clips((3, 4, 5), seed=1)
    rec = Recorder(monkeypatch)
    both = rec.run(lambda: tms.run_streams(engines["torch"], sources))
    monkeypatch.setenv("SMOLVISION_BATCH_STREAMS", "0")
    turns, held = [], []
    init, finalize = tms.StreamSession.__init__, tstream.StreamState.finalize

    def session_init(self, *a, **k):
        init(self, *a, **k)
        turns.append(self.turn)

    def session_finalize(self):
        if turns:
            held.append(turns[-1].locked())
        return finalize(self)

    monkeypatch.setattr(tms.StreamSession, "__init__", session_init)
    monkeypatch.setattr(tstream.StreamState, "finalize", session_finalize)
    threaded = rec.run(lambda: tms.run_streams(engines["torch"], sources))
    assert held == [True] * len(sources)
    assert tokens_and_pieces(threaded[1]) == tokens_and_pieces(both[1])
    assert threaded[0] == both[0]
    assert threaded[1] == solo_runs(rec, engines["torch"], sources)[1]
    # live sources in the threaded mode are polled (nowait), a turn at a time
    lives, _ = _live_sources(LiveAudio, sources, trickle=False)
    live = rec.run(lambda: tms.run_streams(engines["torch"], lives))
    assert tokens_and_pieces(live[1]) == tokens_and_pieces(threaded[1])
    assert live[0] == threaded[0]


def test_stratified_reset_prefill_matches_jax_and_default(engines_2s, monkeypatch):
    """SMOLVISION_MSTREAM_STRAT=1, the JAX package's three arms
    (tests/test_multistream.py): the default, row 0 forced to reuse 0 with
    the stratified reset-row prefill on (its small full prefill, admitted
    back, while S follows the other rows), and row 0 forced with it off.
    The default and strat arms' chunks equal the JAX package's run of the
    same arm (every field), and every arm's equal the port's solo streams
    (tokens and pieces), so the arms equal one another; the strat arm ran
    the stratified prefill on both sides.  The thresholds are patched low (MSTRAT_MIN_S 64,
    MSTRAT_MIN_ACTIVE 2) and the recovery resets disabled, as in the JAX
    test, so that reuse grows past 64 rows on tiny prompts (2 s encoder
    windows, 9 and 10 s clips)."""
    engines = engines_2s
    rng = np.random.default_rng(77)
    sources = []
    for n in (9, 10):
        t = np.arange(n * SR) / SR
        sources.append((0.3 * np.sin(2 * np.pi * (140 + 25 * n) * t)
                        + 0.02 * rng.standard_normal(len(t))).astype(np.float32))
    for ms_mod, st_mod in PKGS.values():
        for name in ("DEGEN_MIN_REPEATS", "STALE_CHUNKS", "MAX_REPEAT_TOKEN_RUN"):
            monkeypatch.setattr(st_mod, name, 1 << 30)
        monkeypatch.setattr(ms_mod, "MSTRAT_MIN_S", 64)
        monkeypatch.setattr(ms_mod, "MSTRAT_MIN_ACTIVE", 2)
    for eng in engines.values():
        monkeypatch.setattr(eng, "past_text_conditioning", False)   # append-only prompts
    solo = solo_runs(Recorder(monkeypatch), engines["torch"], sources)
    for arm in ("default", "forced-strat", "forced-nostrat"):
        force = frozenset() if arm == "default" else frozenset({0})
        for ms_mod, _ in PKGS.values():
            monkeypatch.setattr(ms_mod, "MSTRAT_TEST_FORCE_RESET", force)
        if arm == "forced-strat":
            monkeypatch.setenv("SMOLVISION_MSTREAM_STRAT", "1")
        else:
            monkeypatch.delenv("SMOLVISION_MSTREAM_STRAT", raising=False)
        for eng in engines.values():
            monkeypatch.setattr(eng, "_strat_round_count", 0, raising=False)
        if arm == "forced-nostrat":
            # the port alone, against its solo streams: the JAX package's
            # run of this arm is its default path, held in the default arm
            texts, per = Recorder(monkeypatch).run(
                lambda: batched("torch", engines["torch"], sources))
            assert tokens_and_pieces(per) == tokens_and_pieces(solo[1])
            assert texts == solo[0]
        else:
            texts, per = check_against_jax_and_solo(monkeypatch, engines, sources, solo=solo)
        nonvacuous(per, texts)
        counts = [eng._strat_round_count for eng in engines.values()]
        if arm == "forced-strat":
            assert counts[0] == counts[1] > 0, counts
            rounds = engines["torch"].perf.multistream["rounds"]
            assert any(r["strat_rows"] == [0] and r["S"] >= 64 for r in rounds), rounds
        else:
            assert counts == [0, 0], (arm, counts)
        if arm != "default":
            assert any(c[1] == 0 for c in per[0][1:]), "row 0 was not forced to reuse 0"


def test_session_views_are_isolated(engines):
    eng = engines["torch"]
    view = tms.clone_session(eng)
    view._ensure_kv(256)
    assert eng._kv is not view._kv and view.perf is not eng.perf
    assert view.dec_params is eng.dec_params and view.tokenizer is eng.tokenizer


# ---------------------------------------------------------------------------
# pieces: quantize_block, kv_rows_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pcap", [128 * k for k in range(1, 10)])
def test_quantize_block_invariants(pcap):
    """Every 64-granular (S, W) of the cap: S' <= S, W' >= W, S' + W' <=
    pcap, S' 64-granular, W' a power of two or the full cap (on the JAX
    package's ladder), and the JAX package's answer."""
    for S in range(0, pcap, 64):
        for W in range(64, pcap - S + 1, 64):
            S2, W2 = tms.quantize_block(S, W, pcap)
            assert (S2, W2) == jms.quantize_block(S, W, pcap)
            assert 0 <= S2 <= S and W2 >= W and S2 + W2 <= pcap and S2 % 64 == 0
            assert W2 == pcap or W2 in {64, 128, 256, 512, 1024}, (S, W, pcap, S2, W2)


def test_quantize_block_documented_examples():
    assert tms.quantize_block(64, 320, 384) == (0, 384)    # Wq 512 >= pcap
    assert tms.quantize_block(64, 192, 512) == (64, 256)
    assert tms.quantize_block(128, 64, 512) == (128, 64)   # already on the ladder


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
def test_kv_rows_gather_matches_jax(kind):
    """Rows (2, 0, 2, 2) of a [L, 2, 3, KH, K, D] cache (a repeated pad
    row, as compaction pads), both leaves of an int8 cache; the result owns
    its storage, so writes into the old cache do not reach it."""
    rng = np.random.default_rng(7)
    shape = (2, 2, 3, 2, 8, 4)
    x = rng.standard_normal(shape).astype(np.float32)
    rows = (2, 0, 2, 2)
    if kind == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = rng.random(shape[:-1]).astype(np.float32)
        got = tquant.kv_rows_gather(tquant.QuantKV(torch.from_numpy(q), torch.from_numpy(s)),
                                    rows)
        want = jquant.kv_rows_gather(jquant.QuantKV(jnp.asarray(q), jnp.asarray(s)), rows)
        pairs = [(got.q, want.q), (got.s, want.s)]
    else:
        t = torch.from_numpy(x).to(getattr(torch, kind))
        got = tquant.kv_rows_gather(t, rows)
        want = jquant.kv_rows_gather(jnp.asarray(t.float().numpy()), rows)
        pairs = [(got.float(), want)]
        t.fill_(0)
        assert float(got.float().abs().max()) > 0
    for g, w in pairs:
        assert tuple(g.shape) == tuple(w.shape) == shape[:2] + (4,) + shape[3:len(g.shape)]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_multistream_stdout_byte_equal(model_dir, tmp_path):
    """--f32 --stream -i a b c: one line per file, in file order, byte-equal
    to the JAX CLI's; the Streams line on stderr."""
    from tests.test_torch_engine import _wav_bytes

    wavs = []
    for i, c in enumerate(clips((3, 5, 4), seed=50)):
        wavs.append(tmp_path / f"c{i}.wav")
        wavs[-1].write_bytes(_wav_bytes(c))
    args = ["-d", model_dir, "-i", *map(str, wavs), "--stream", "--f32",
            "--stream-max-new-tokens", "6"]
    out = []
    for module in ("smolvision_tpu.cli", "smolvision_tpu_torch.cli"):
        env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu")
        r = subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                           timeout=600, env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr.decode()
        out.append(r)
    assert out[1].stdout == out[0].stdout
    lines = out[1].stdout.decode().splitlines()
    assert len(lines) == 3 and any(lines)
    assert "Streams: 3 sessions, 12.0 s audio in" in out[1].stderr.decode()
