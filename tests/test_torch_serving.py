"""The port's continuous-batching scheduler against the JAX package's and its
own static batch, on the tiny f32 checkpoint with the full vocabulary (every
decoded id is visible text), also with bf16 weights and cache and with the
int8 cache (--kv8); and the CLI's several-file modes byte-equal to the JAX
CLI under --f32.

Admission waves, slot reuse, the per-row region_start mask of late rows and
admit_cap may never change greedy tokens: rows are independent.  The waves
of a dense decoder run through decode_graph.WaveGraph (on the CPU its step
runs eagerly; a stub capture stands in for the card's CUDA graph).
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.runtime import serving as jserving
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.kernels import ffi
from smolvision_tpu_torch.kernels import flash_attention as tfa
from smolvision_tpu_torch.parallel import batch as tbatch
from smolvision_tpu_torch.runtime import batch_segments as tbs
from smolvision_tpu_torch.runtime import decode_graph
from smolvision_tpu_torch.runtime import serving as tserving
from smolvision_tpu_torch.runtime.engine import Engine
from tests.workloads import serving_clips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def visible_model_dir(tmp_path_factory):
    from tools.make_tiny_model import build

    return build("tiny", str(tmp_path_factory.mktemp("visible") / "model"), seed=5,
                 dtype="f32", full_vocab=True)


# (JAX engine keywords, port engine keywords) per engine pair
ENGINE_KINDS = {
    "f32": (dict(param_dtype=jnp.float32, kv_dtype=jnp.float32),
            dict(param_dtype=torch.float32, kv_dtype=torch.float32)),
    "bf16": (dict(param_dtype=jnp.bfloat16, kv_dtype=jnp.bfloat16),
             dict(param_dtype=torch.bfloat16, kv_dtype=torch.bfloat16)),
    "kv8": (dict(param_dtype=jnp.float32, kv_dtype=jnp.float32, kv8=True),
            dict(param_dtype=torch.float32, kv_dtype=torch.float32, kv8=True)),
}


@pytest.fixture(scope="module")
def engine_pairs(visible_model_dir):
    """kind -> (JAX engine, port engine), each pair loaded on first use."""
    pairs = {}

    def get(kind):
        if kind not in pairs:
            jkw, tkw = ENGINE_KINDS[kind]
            j = JEngine(visible_model_dir, **jkw)
            t = Engine(visible_model_dir, device="cpu", **tkw)
            for eng in (j, t):
                eng.max_tokens = 8
                eng.set_force_language("English")
            pairs[kind] = (j, t)
        return pairs[kind]

    return get


@pytest.fixture(scope="module")
def engines(engine_pairs):
    return engine_pairs("f32")


@pytest.mark.parametrize("kind,n,slots,admit_cap", [
    # three waves, slot reuse, late rows masked by region_start
    pytest.param("f32", 5, 2, 0, id="5-2-0"),
    # admit_cap: sub-waves of 2 into a 4-slot batch
    pytest.param("f32", 6, 4, 2, id="6-4-2"),
    # one wave: everything fits
    pytest.param("f32", 3, 8, 0, id="3-8-0"),
    # three waves of 2 at one wave graph key: first, capture, replay
    pytest.param("bf16", 6, 2, 0, id="bf16-6-2-0"),
    # sub-waves of 1 on the int8 cache: first, capture, replay
    pytest.param("kv8", 3, 2, 1, id="kv8-3-2-1"),
])
def test_serve_continuous_matches_jax_and_static_batch(engine_pairs, kind, n, slots, admit_cap):
    jeng, teng = engine_pairs(kind)
    clips = serving_clips(n, seed=21 + n)
    want = jserving.serve_continuous(jeng, clips, slots=slots, admit_cap=admit_cap)
    teng.perf.reset()
    got = tserving.serve_continuous(teng, clips, slots=slots, admit_cap=admit_cap)
    assert got == want and any(got)
    assert got == tbs.transcribe_segments_batched(teng, clips)
    lat = teng.perf.serving_latency
    assert lat["clips"] == n and lat["ttft_p50_ms"] <= lat["done_p99_ms"]
    waves = -(-n // min(slots, admit_cap or slots))
    assert teng.perf.delta_prefills >= waves
    # the wave graph where the first wave's shape recurs 3 times or more
    hows = [w["how"] for w in teng.perf.serving_waves]
    if (n, slots, admit_cap) in ((5, 2, 0), (3, 8, 0)):
        assert hows == ["eager"] * len(hows), hows
    else:
        assert hows[:3] == ["first", "capture", "replay"], hows


def test_serving_raw_rows_equal_static_batch_rows(engines):
    """Raw token rows, not only texts: the scheduler's rows (cut at EOS) are
    the static batch's."""
    _, teng = engines
    clips = serving_clips(5, seed=3)
    rows = tserving.decode_continuous(teng, clips, slots=2)
    want = tbs.decode_segments_batched(teng, clips)
    assert [tbatch.trim_eos(r) for r in rows] == [tbatch.trim_eos(r) for r in want]


def test_wave_graphs_pool_capture_replay_and_shadow(engines, monkeypatch):
    """A stub capture (its step's Python runs once, the launches it counts
    are taken back; a replay computes the step and counts nothing, as a
    CUDA graph's).  Seven clips through two slots: waves of 2, 2, 2 and 1.
    The (Gcap 2, acap) key's first wave runs eagerly, its second is
    captured, its third replays; Gcap 1 makes a new graph on a cache of
    its own.  Each key's waves share one pooled small cache; each wave
    counts one prefill's B5 launches once; its first tokens are read once,
    at its admission, never inside a decode chunk; every wave after the
    first is dispatched inside a chunk's shadow (its clips encoded).  The
    rows equal the eager waves' (fresh cache, host start), the route of a
    shorter queue, of a "model" axis and of an MoE decoder."""
    _, teng = engines
    L = teng.cfg.dec_layers
    captured, made, smalls, events = [], [], [], []
    in_chunk = [False]

    def stub_capture(fn, stream):
        fn()
        captured.append(fn)

        def replay():
            kept = dict(ffi.launch_counts)
            fn()
            ffi.launch_counts.update(kept)

        return replay

    def counting_b5(*args, **kwargs):   # the plain version counts no launch: count here
        ffi.launch_counts["batched_cache_attention"] += 1
        return b5(*args, **kwargs)

    def spy_graph(params, cfg, kv, audio, pcap, perf=None):
        made.append((kv, tuple(audio.shape[:2])))
        return wave_graph(params, cfg, kv, audio, pcap, perf)

    def spy_admit(big, small, rows, G, src=None):
        smalls.append(small)
        return admit_rows(big, small, rows, G, src)

    def spy_read(x, group, dev):
        events.append(("read", in_chunk[0]))
        return gather(x, group, dev)

    def spy_wave_run(self, audio, ints):
        events.append(("dispatch", in_chunk[0]))
        return wave_run(self, audio, ints)

    def spy_loop_run(self, *args, **kwargs):
        in_chunk[0] = True
        try:
            return loop_run(self, *args, **kwargs)
        finally:
            in_chunk[0] = False

    b5, wave_graph, admit_rows = tfa.batched_cache_flash_attention, tbatch.serving_wave_graph, \
        tbatch.admit_rows
    gather, wave_run = tserving.gather_host, decode_graph.WaveGraph.run
    loop_run = decode_graph.DecodeLoop.run
    clips = serving_clips(7, seed=28)
    with monkeypatch.context() as m:
        m.setattr(tserving, "wave_graphs", lambda engine, axis: False)
        teng.perf.reset()
        eager_rows = tserving.decode_continuous(teng, clips, slots=2)
        assert [w["how"] for w in teng.perf.serving_waves] == ["eager"] * 4
    monkeypatch.setattr(decode_graph, "capture", stub_capture)
    monkeypatch.setattr(tfa, "batched_cache_flash_attention", counting_b5)
    monkeypatch.setattr(tbatch, "serving_wave_graph", spy_graph)
    monkeypatch.setattr(tbatch, "admit_rows", spy_admit)
    monkeypatch.setattr(tserving, "gather_host", spy_read)
    monkeypatch.setattr(decode_graph.WaveGraph, "run", spy_wave_run)
    monkeypatch.setattr(decode_graph.DecodeLoop, "run", spy_loop_run)
    teng.perf.reset()
    before = ffi.launch_counts["batched_cache_attention"]
    rows = tserving.decode_continuous(teng, clips, slots=2)
    assert rows == eager_rows
    waves = teng.perf.serving_waves
    assert [(w["rows"], w["how"], w["shadow"]) for w in waves] == [
        (2, "first", False), (2, "capture", True), (2, "replay", True), (1, "first", True)]
    assert all("read_ms" in w for w in waves)
    # each record: no device ms on the CPU, one admission time per clip (pad
    # rows none), the serving latency's first-token times the same numbers
    assert [(w["device_ms"], len(w["clips"]), len(w["admit_wait_ms"])) for w in waves] == [
        (None, 2, 2), (None, 2, 2), (None, 2, 2), (None, 1, 1)]
    admit = sorted(ms for w in waves for ms in w["admit_wait_ms"])
    assert teng.perf.serving_latency["ttft_min_ms"] == round(admit[0], 1)
    spans = teng.perf.spans
    assert spans["serve.call"].count == 1 and spans["serve.wave"].count == 4
    assert spans["serve.wait_first"].count == spans["serve.admit"].count == 4
    assert teng.perf.prefill_ms == pytest.approx(spans["serve.wave"].host_ms
                                                 + spans["serve.wait_first"].host_ms)
    assert ffi.launch_counts["batched_cache_attention"] - before == 4 * L
    assert teng.perf.delta_prefills == 4 and teng.perf.prefill_replays == 2
    assert [type(fn.__self__) for fn in captured].count(decode_graph.WaveGraph) == 1
    assert [shape[0] for _, shape in made] == [2, 1] and made[0][1][1] == made[1][1][1]
    # each wave's admissions read its key's one pooled cache
    assert all(s is made[0][0] for s in smalls[:3]) and smalls[-1] is made[1][0]
    # dispatch, then its one read at admission: the first wave synchronously,
    # later ones from a chunk's shadow
    assert events == [("dispatch", False), ("read", False)] + [("dispatch", True),
                                                               ("read", False)] * 3
    # a queue whose first wave shape recurs fewer than 3 times, a "model"
    # axis (tp > 1) and an MoE decoder keep the eager waves
    assert tserving.WAVE_GRAPH_MIN_WAVES == 3
    assert [tserving.waves_at_shape(n, W) for n, W in
            ((7, 2), (6, 2), (5, 2), (7, 4), (6, 4), (64, 16), (8, 4), (1, 1))] == \
        [3, 3, 2, 2, 1, 4, 2, 1]
    assert tserving.wave_graphs(teng, None)
    assert not tserving.wave_graphs(teng, object())
    assert not tserving.wave_graphs(SimpleNamespace(dec_params={"moe_layers": [0]}), None)


def test_admit_rows_copies_block_rows():
    big = torch.zeros(2, 2, 4, 1, 8, 2)
    small = torch.arange(2 * 2 * 2 * 1 * 5 * 2, dtype=torch.float32).reshape(2, 2, 2, 1, 5, 2)
    tbatch.admit_rows(big, small, [3, 1], 2, src=[1, 0])
    assert torch.equal(big[:, :, 3, :, :5], small[:, :, 1])
    assert torch.equal(big[:, :, 1, :, :5], small[:, :, 0])
    assert not big[:, :, (0, 2)].any() and not big[..., 5:, :].any()


def _wav_bytes(samples, rate=16000):
    import struct

    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for i, clip in enumerate(serving_clips(3, seed=5)):
        p = d / f"clip{i}.wav"
        p.write_bytes(_wav_bytes(clip))
        paths.append(str(p))
    return paths


def _cli(module, args):
    env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                          timeout=600, env=env, cwd=REPO)


@pytest.mark.parametrize("extra", [["--serve", "2"], ["--serve", "2", "--serve-admit", "1"]])
def test_cli_serve_stdout_byte_equal(visible_model_dir, wavs, extra):
    args = ["-d", visible_model_dir, "-i", *wavs, "--f32", "--language", "English",
            "--max-tokens", "8"] + extra
    j = _cli("smolvision_tpu.cli", args)
    t = _cli("smolvision_tpu_torch.cli", args)
    assert j.returncode == 0, j.stderr.decode()
    assert t.returncode == 0, t.stderr.decode()
    assert len(t.stdout.decode().splitlines()) == 3 and t.stdout.strip()
    assert t.stdout == j.stdout
    err = t.stderr.decode()
    assert "Batch: 3 files" in err and "Serve: ttft p50" in err
