"""The port's batched path against the JAX package on the tiny f32 checkpoint:
the batched decoder (fresh prefill through kernel B4's plain version, delta
prefill through B5's, decode), the batched encoder, batched segment
transcription, the segment.py host helpers, and the -S CLI.

Logits must agree within 1e-4 of their largest magnitude (both sides are f32
and differ only in summation order) and greedy tokens exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.models import qwen3_decoder as jdec
from smolvision_tpu.runtime import batch_segments as jbs
from smolvision_tpu.runtime import segment as jseg
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.models import qwen3_decoder as tdec
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.parallel import batch as tbatch
from smolvision_tpu_torch.runtime import batch_segments as tbs
from smolvision_tpu_torch.runtime import segment as tseg
from smolvision_tpu_torch.runtime.engine import Engine

LOGIT_RTOL = 1e-4


@pytest.fixture(scope="module")
def visible_model_dir(tmp_path_factory):
    """The tiny f32 checkpoint with the full vocabulary: every decoded id is
    visible text, so transcript comparisons are not vacuous."""
    from tools.make_tiny_model import build

    return build("tiny", str(tmp_path_factory.mktemp("visible") / "model"), seed=5,
                 dtype="f32", full_vocab=True)


@pytest.fixture(scope="module")
def engines(visible_model_dir):
    j = JEngine(visible_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32)
    t = Engine(visible_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
               device="cpu")
    for eng in (j, t):
        eng.max_tokens = 8
    return j, t


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _embeds(cfg, B, T, seed):
    return (np.random.default_rng(seed).standard_normal((B, T, cfg.dec_hidden)) * 0.5
            ).astype(np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


@pytest.mark.parametrize("pads", [(0, 0), (0, 10, 63), (5, 64, 17, 30)])
def test_batched_prefill_matches_jax(engines, pads):
    """Fresh prefill in the left-padded layout; an all-pad row (pad == T)
    included.  Logits, tokens and the cache rows written."""
    jeng, teng = engines
    cfg = teng.cfg
    B, T, K = len(pads), 64, 128
    emb = _embeds(cfg, B, T, len(pads))
    pads = _i32(pads)
    jl, jkv = jdec.batched_prefill(jeng.dec_params, jeng.cfg, jnp.asarray(emb),
                                   jdec.make_batched_kv(jeng.cfg, B, K, jnp.float32),
                                   jnp.asarray(-pads), jnp.asarray(pads), greedy=False)
    tl, tkv = tdec.batched_prefill(teng.dec_params, cfg, torch.from_numpy(emb),
                                   tdec.make_batched_kv(cfg, B, K, torch.float32, "cpu"),
                                   torch.from_numpy(-pads), torch.from_numpy(pads), greedy=False)
    _close_logits(tl.numpy(), jl)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), rtol=1e-5, atol=1e-5)
    toks, _ = tbatch.batched_prefill(teng.dec_params, cfg, torch.from_numpy(emb),
                                     tdec.make_batched_kv(cfg, B, K, torch.float32, "cpu"),
                                     torch.from_numpy(-pads), torch.from_numpy(pads))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jl).argmax(-1))


def test_batched_prefill_delta_start0_natural_layout(engines):
    """Serving's group prefill: start 0, per-row prompt_max, last_rows at each
    row's last prompt token, region_start past the cache."""
    jeng, teng = engines
    cfg = teng.cfg
    B, T = 4, 64
    emb = _embeds(cfg, B, T, 7)
    lens = _i32([64, 40, 17, 1])
    z = np.zeros(B, np.int32)
    jl, jkv = jdec.batched_prefill_delta(
        jeng.dec_params, jeng.cfg, jnp.asarray(emb), jnp.int32(0),
        jdec.make_batched_kv(jeng.cfg, B, T, jnp.float32), jnp.asarray(z), jnp.asarray(z),
        greedy=False, last_rows=jnp.asarray(lens - 1), prompt_max=jnp.asarray(lens),
        region_start=jnp.int32(1 << 30))
    tl, tkv = tdec.batched_prefill_delta(
        teng.dec_params, cfg, torch.from_numpy(emb), 0,
        tdec.make_batched_kv(cfg, B, T, torch.float32, "cpu"), torch.from_numpy(z),
        torch.from_numpy(z), greedy=False, last_rows=torch.from_numpy(lens - 1),
        prompt_max=torch.from_numpy(lens), region_start=1 << 30)
    _close_logits(tl.numpy(), jl)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), rtol=1e-5, atol=1e-5)


def test_batched_prefill_delta_after_cache_per_row_region(engines):
    """Delta prefill at start > 0 against a cache a fresh prefill wrote, with
    per-row kv_min, prompt_max and region_start (the multistream shape)."""
    jeng, teng = engines
    cfg = teng.cfg
    B, T0, T, K = 3, 64, 64, 192
    e0, e1 = _embeds(cfg, B, T0, 8), _embeds(cfg, B, T, 9)
    pads = _i32([0, 7, 30])
    pm, rs = _i32([64, 50, 33]), _i32([40, 64, 60])
    jkv = jdec.make_batched_kv(jeng.cfg, B, K, jnp.float32)
    _, jkv = jdec.batched_prefill(jeng.dec_params, jeng.cfg, jnp.asarray(e0), jkv,
                                  jnp.asarray(-pads), jnp.asarray(pads))
    jl, jkv = jdec.batched_prefill_delta(
        jeng.dec_params, jeng.cfg, jnp.asarray(e1), jnp.int32(T0), jkv,
        jnp.asarray(T0 - pads), jnp.asarray(pads), greedy=False,
        prompt_max=jnp.asarray(pm), region_start=jnp.asarray(rs))
    tkv = tdec.make_batched_kv(cfg, B, K, torch.float32, "cpu")
    _, tkv = tdec.batched_prefill(teng.dec_params, cfg, torch.from_numpy(e0), tkv,
                                  torch.from_numpy(-pads), torch.from_numpy(pads))
    tl, tkv = tdec.batched_prefill_delta(
        teng.dec_params, cfg, torch.from_numpy(e1), T0, tkv, torch.from_numpy(T0 - pads),
        torch.from_numpy(pads), greedy=False, prompt_max=torch.from_numpy(pm),
        region_start=torch.from_numpy(rs))
    _close_logits(tl.numpy(), jl)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("active", [(True, True, True), (True, False, True)])
def test_batched_decode_chunk_matches_jax(engines, active):
    """Decode chunk after a left-padded prefill: buffer, count and last
    tokens equal JAX's, with and without an inactive row."""
    jeng, teng = engines
    cfg = teng.cfg
    B, T, K, cap = 3, 64, 128, 8
    emb = _embeds(cfg, B, T, 11)
    pads = _i32([0, 12, 40])
    act = np.asarray(active)
    jtok, jkv = jdec.batched_prefill(jeng.dec_params, jeng.cfg, jnp.asarray(emb),
                                     jdec.make_batched_kv(jeng.cfg, B, K, jnp.float32),
                                     jnp.asarray(-pads), jnp.asarray(pads))
    jbuf, jn, jlast, _ = jdec.batched_decode_chunk(
        jeng.dec_params, jeng.cfg, jtok, jnp.int32(T), jkv, cap, jnp.asarray(pads),
        jnp.asarray(pads), n_steps=jnp.int32(6), row_active=jnp.asarray(act))
    ttok, tkv = tdec.batched_prefill(teng.dec_params, cfg, torch.from_numpy(emb),
                                     tdec.make_batched_kv(cfg, B, K, torch.float32, "cpu"),
                                     torch.from_numpy(-pads), torch.from_numpy(pads))
    tbuf, tn, tlast, _ = tbatch.batched_decode_chunk(
        teng.dec_params, cfg, ttok, T, tkv, cap, rope_offset=torch.from_numpy(pads),
        kv_min=torch.from_numpy(pads), n_steps=6, row_active=torch.from_numpy(act))
    assert tn == int(jn)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


def test_batched_decode_chunk_exits_when_all_rows_done(engines):
    _, teng = engines
    cfg = teng.cfg
    kv = tdec.make_batched_kv(cfg, 2, 64, torch.float32, "cpu")
    eos = torch.full((2,), 151645, dtype=torch.int32)
    buf, n, last, _ = tbatch.batched_decode_chunk(teng.dec_params, cfg, eos, 16, kv, 8)
    assert n == 0 and not buf.any() and torch.equal(last, eos)
    toks = torch.tensor([3, 5], dtype=torch.int32)
    buf, n, _, _ = tbatch.batched_decode_chunk(teng.dec_params, cfg, toks, 16, kv, 8,
                                               row_active=torch.tensor([False, False]))
    assert n == 0


def _clips(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.2).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("lengths", [(16000, 24000, 32000), (4000, 12000)])
def test_batched_encoder_matches_jax(engines, lengths):
    """The batched encode (one conv call for all full chunks, tails by width,
    one windowed-encoder pass over all clips) against the JAX package's."""
    jeng, teng = engines
    mels = [log_mel(c) for c in _clips(3, lengths)]
    jstack, jn = jbs._encode_batch(jeng, mels)
    tstack, tn = tbs._encode_batch(teng, mels)
    assert tn == jn
    for b, n in enumerate(tn):
        np.testing.assert_allclose(tstack[b, :n].numpy(), np.asarray(jstack)[b, :n],
                                   rtol=2e-4, atol=2e-4)


def test_length_groups_match_jax(engines, monkeypatch):
    jeng, teng = engines
    segs = _clips(9, (16000, 16 * 16000, 16000, 16 * 16000, 6 * 16000))
    monkeypatch.setenv("SMOLVISION_SUBBATCH_OVERHEAD", "1")
    for eng in (jeng, teng):
        eng.prepare_prompt()
    assert tbs._length_groups(teng, segs) == jbs._length_groups(jeng, segs)
    assert len(tbs._length_groups(teng, segs)) == 3


def _jax_greedy_rows(jeng, segs):
    """Each segment's greedy tokens through the JAX engine's sequential path."""
    from smolvision_tpu.runtime import prompt as jprompt

    rows = []
    for s in segs:
        audio, n_audio = jeng.encode_mel(log_mel(s))
        ids, a0 = jprompt.build_asr_prompt(jeng.cfg, n_audio, jeng._prompt_tokens,
                                           jeng._force_tokens)
        jeng.reset_kv()
        first, pos = jeng.prefill_ids(ids, audio, a0, n_audio)
        got = []
        jeng.decode_greedy(first, pos, jeng.max_tokens, lambda t: got.append(t) or True)
        rows.append(got)
    return rows


@pytest.mark.parametrize("force", [None, "English"])
def test_transcribe_segments_batched_matches_jax(engines, force):
    """Texts equal the JAX package's batched texts, and the raw token rows
    (cut at EOS) equal the JAX engine's sequential greedy tokens."""
    jeng, teng = engines
    segs = _clips(3, (16000, 24000, 32000, 12000))
    for eng in (jeng, teng):
        eng.set_force_language(force)
    try:
        want = jbs.transcribe_segments_batched(jeng, segs)
        assert tbs.transcribe_segments_batched(teng, segs) == want
        rows = tbs.decode_segments_batched(teng, segs)
        want_rows = _jax_greedy_rows(jeng, segs)
    finally:
        for eng in (jeng, teng):
            eng.set_force_language(None)
    assert [tbatch.trim_eos(r) for r in rows] == want_rows
    assert all(len(r) == teng.max_tokens or r[-1] in (151643, 151645) for r in rows)


def _long_audio():
    rng = np.random.default_rng(7)
    sr = 16000
    t = np.arange(6 * sr) / sr
    sig = (0.3 * np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
           + 0.01 * rng.standard_normal(len(t)))
    sig[int(2.9 * sr): int(3.1 * sr)] *= 0.01
    return sig.astype(np.float32)


@pytest.mark.parametrize("batch,past", [(True, False), (False, False), (False, True)])
def test_transcribe_audio_segmented_matches_jax(engines, batch, past):
    """-S 2 -W 0.5 on 6 s: batched segments, sequential, and sequential with
    past-text conditioning (its retry rules included), with a forced
    language so every decoded token is text."""
    jeng, teng = engines
    audio = _long_audio()
    for eng in (jeng, teng):
        eng.segment_sec, eng.search_sec = 2.0, 0.5
        eng.batch_segments, eng.past_text_conditioning = batch, past
        eng.set_force_language("English")
    try:
        want = jseg.transcribe_audio(jeng, audio)
        teng.perf.reset()
        got = tseg.transcribe_audio(teng, audio)
    finally:
        for eng in (jeng, teng):
            eng.segment_sec, eng.batch_segments, eng.past_text_conditioning = 0.0, True, False
            eng.set_force_language(None)
    assert got == want and got
    if batch:
        assert teng.perf.fresh_prefills == 1 and teng.perf.prefills == 0
    else:
        assert teng.perf.fresh_prefills == 0 and teng.perf.prefills >= 3


def _speechy(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = 0.3 * np.sin(2 * np.pi * 200 * t) * (np.sin(2 * np.pi * 0.7 * t) > -0.2)
    sig = sig + 0.003 * rng.standard_normal(len(t))
    return sig.astype(np.float32)


@pytest.mark.parametrize("seconds,segment,search", [
    (3.0, 1.0, 0.4), (12.0, 5.0, 3.0), (30.0, 4.0, 1.0), (2.0, 5.0, 3.0),
])
def test_split_points_match_jax(seconds, segment, search):
    audio = _speechy(seconds, int(seconds))
    assert tseg.split_points(audio, segment, search) == jseg.split_points(audio, segment, search)
    target = int(len(audio) * 0.4)
    assert (tseg.find_split_point(audio, target, search)
            == jseg.find_split_point(audio, target, search))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_silence_matches_jax_numpy_mask(seed):
    rng = np.random.default_rng(seed)
    sr = 16000
    audio = (0.002 * rng.standard_normal(8 * sr)).astype(np.float32)
    for s0 in (0.5, 3.0, 6.2):
        a, b = int(s0 * sr), int((s0 + 0.4 + 0.3 * seed) * sr)
        audio[a:b] += 0.3 * np.sin(np.arange(b - a) * 0.07).astype(np.float32)
    np.testing.assert_array_equal(tseg._silence_keep_mask_numpy(audio),
                                  jseg._silence_keep_mask_numpy(audio))
    got = tseg.compact_silence(audio)
    assert 0 < len(got) < len(audio)
    np.testing.assert_array_equal(got, jseg.compact_silence(audio))


@pytest.mark.parametrize("full,seg,core,n", [
    ("", "", 16000, 3), ("abc", "x" * 10, 9 * 16000, 5), ("abc", "x" * 10, 9 * 16000, 30),
    ("prefix " + "y" * 60, "y" * 50, 16000, 20), ("z", "中" * 20, 16000, 20),
])
def test_retry_and_boundary_rules_match_jax(full, seg, core, n):
    assert (tseg.should_retry_unconditioned(full, seg, core, n)
            == jseg.should_retry_unconditioned(full, seg, core, n))
    for prev, nxt in (("a", "b"), ("a", ","), (" ", "b"), ("中", "　"), ("", "x")):
        assert (tseg._should_insert_boundary_space(prev, nxt)
                == jseg._should_insert_boundary_space(prev, nxt))


def _wav_bytes(samples, rate=16000):
    import struct

    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory, speech_like_audio):
    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for i, clip in enumerate([speech_like_audio, _long_audio()[: 2 * 16000]]):
        p = d / f"clip{i}.wav"
        p.write_bytes(_wav_bytes(clip))
        paths.append(str(p))
    return paths


def _cli(module, args):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, SMOLVISION_PLATFORM="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                          timeout=600, env=env, cwd=repo)


@pytest.mark.parametrize("mode", [
    ["-S", "1", "-W", "0.4", "--silent"],                          # batched segments
    ["-S", "1", "-W", "0.4", "--no-batch-segments"],               # sequential, streamed
    ["-S", "1", "-W", "0.4", "--past-text", "yes", "--silent"],    # conditioned
    ["--two-files", "--silent"],                                   # one static batch
])
def test_cli_stdout_byte_equal(visible_model_dir, wavs, mode):
    files = wavs if "--two-files" in mode else wavs[:1]
    mode = [m for m in mode if m != "--two-files"]
    args = ["-d", visible_model_dir, "-i", *files, "--f32", "--language", "English",
            "--max-tokens", "8"] + mode
    j = _cli("smolvision_tpu.cli", args)
    t = _cli("smolvision_tpu_torch.cli", args)
    assert j.returncode == 0, j.stderr.decode()
    assert t.returncode == 0, t.stderr.decode()
    assert t.stdout.strip()
    assert t.stdout == j.stdout
    if len(files) > 1:
        assert len(t.stdout.decode().splitlines()) == 2
