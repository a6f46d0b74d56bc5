"""The port's mesh paths over two `gloo` ranks on the CPU, against the port's
single process and the JAX package's single device.

One module-scoped spawn of two rank processes (tests/torch_mesh_worker.py,
which imports the port only) runs every case; meanwhile this process
computes the references.  The spawn has its own wall-clock limit and kills
its ranks when it passes, so a hang fails these tests only.  Cases (the
JAX package's own DP / TP / EP tests, which its 8-device CPU mesh runs):
  * serve_continuous at (dp 2, tp 1) and (1, 2), on the tiny MoE
    checkpoint with visible ids and a forced language
    (tests/test_serving.py:181; at (1, 2) its experts split over "model":
    the JAX package's expert parallelism), and at (2, 1) on an int8 cache
    (tests/test_kv8.py:198);
  * transcribe_segments_batched at (2, 1) on three segments: one pad row
    (tests/test_batch_segments.py:260);
  * the multistream coordinator at (2, 1), f32 and int8 cache, per chunk
    (tests/test_multistream.py:643, tests/test_kv8.py:228);
  * the encoder's sequence parallelism: the group encode's audio rows
    within 1e-6 (tests/test_enc_sp.py:39);
  * a decode loop whose rows emit an EOS inside a chunk on one rank's rows
    only: one count for every rank, the buffer of one process;
  * one batched prefill plus a decode chunk at (1, 2) on the decoder of
    tests/test_tp.py, against the JAX package's make_mesh(2, tp=2) run.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smolvision_tpu.ops.mel import log_mel as jlog_mel
from smolvision_tpu.runtime import batch_segments as jbs
from smolvision_tpu.runtime import multistream as jms
from smolvision_tpu.runtime import serving as jserving
from smolvision_tpu.runtime import stream as jstream
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.runtime import batch_segments as tbs
from smolvision_tpu_torch.runtime import multistream as tms
from smolvision_tpu_torch.runtime import serving as tserving
from smolvision_tpu_torch.runtime import stream as tstream
from smolvision_tpu_torch.runtime.engine import Engine
from tests import test_tp
from tests.test_torch_stream import build_stream_model, speech
from tests.torch_mesh_worker import finish_ranks, start_ranks
from tests.workloads import serving_clips

SPAWN_LIMIT_S = 240
SERVE = {"max_tokens": 12}
STREAM = {"stream_max_new_tokens": 6, "max_tokens": 16, "past_text_conditioning": True}


def _save_audio(path, clips):
    np.savez(path, **{str(i): c for i, c in enumerate(clips)})
    return path


class Spy:
    """Per-chunk token lists of every stream session, either package."""

    def __init__(self):
        self.log = []
        self.saved = []

    def __enter__(self):
        for mod in (jstream, tstream):
            finish = mod.StreamState.finish_chunk

            def spy(state, w, chunk_tokens, *args, _finish=finish):
                self.log.append(list(chunk_tokens))
                return _finish(state, w, chunk_tokens, *args)

            self.saved.append((mod.StreamState, finish))
            mod.StreamState.finish_chunk = spy
        return self

    def __exit__(self, *exc):
        for cls, finish in self.saved:
            cls.finish_chunk = finish


def _engines(model, settings, language=None, kv8=False):
    j = JEngine(model, param_dtype=jnp.float32, kv_dtype=jnp.float32, kv8=kv8)
    t = Engine(model, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu", kv8=kv8)
    for eng in (j, t):
        for k, v in settings.items():
            setattr(eng, k, v)
        if language:
            assert eng.set_force_language(language)
    return j, t


def _tp_decoder_files(workdir):
    """The decoder and inputs of tests/test_tp.py's _run_meshed, as npz."""
    from smolvision_tpu.models.synthetic import synthetic_decoder

    params = synthetic_decoder(test_tp.CFG, param_dtype=jnp.float32, seed=7)
    flat = {"embed": np.asarray(params["embed"]), "final_norm": np.asarray(params["final_norm"])}
    flat.update({f"layers.{k}": np.asarray(v) for k, v in params["layers"].items()
                 if v is not None})
    np.savez(os.path.join(workdir, "tp_params.npz"), **flat)
    rng = np.random.default_rng(11)     # _run_meshed's embeddings
    embeds = rng.standard_normal((8, 16, test_tp.CFG.dec_hidden)).astype(np.float32)
    np.savez(os.path.join(workdir, "tp_embeds.npz"), embeds=embeds)
    cfg = {k: getattr(test_tp.CFG, k) for k in ("dec_hidden", "dec_layers", "dec_heads",
                                                 "dec_kv_heads", "dec_head_dim",
                                                 "dec_intermediate", "vocab_size")}
    return cfg


@pytest.fixture(scope="module")
def runs(moe_visible_model_dir, tmp_path_factory):
    """Start the ranks, compute the references meanwhile, then collect."""
    work = str(tmp_path_factory.mktemp("mesh"))
    stream_model = build_stream_model(os.path.join(work, "tiny-untied"))
    serve_audio = _save_audio(os.path.join(work, "serve.npz"), serving_clips(6, seed=5))
    rng = np.random.default_rng(9)
    segs = [(rng.standard_normal(16000 * (1 + i)) * 0.2).astype(np.float32) for i in range(3)]
    seg_audio = _save_audio(os.path.join(work, "segs.npz"), segs)
    streams = [speech(s, seed=40 + i) for i, s in enumerate((3.0, 4.0, 5.0))]
    stream_audio = _save_audio(os.path.join(work, "streams.npz"), streams)
    tp_cfg = _tp_decoder_files(work)
    moe = {"model": moe_visible_model_dir, "language": "English", "settings": SERVE}
    ms_case = {"kind": "multistream", "mesh": [2, 1], "model": stream_model,
               "audio": stream_audio, "settings": STREAM}
    cases = [
        dict(moe, name="serve_dp", kind="serve", mesh=[2, 1], audio=serve_audio, slots=4),
        dict(moe, name="serve_tp", kind="serve", mesh=[1, 2], audio=serve_audio, slots=4),
        dict(moe, name="serve_kv8", kind="serve", mesh=[2, 1], kv8=True, audio=serve_audio,
             slots=4),
        dict(moe, name="segments", kind="segments", mesh=[2, 1], audio=seg_audio),
        dict(moe, name="encode", kind="encode", mesh=[2, 1], audio=seg_audio),
        dict(moe, name="encode_device_mel", kind="encode", mesh=[2, 1], audio=seg_audio,
             device_mel=True),
        dict(ms_case, name="mstream"),
        dict(ms_case, name="mstream_kv8", kv8=True),
        {"name": "loop_eos", "kind": "loop_eos", "mesh": [2, 1], "pos": 40, "steps": 12,
         "stop_at": [2, 5, 9, 7]},
        {"name": "tp_chunk", "kind": "tp_chunk", "mesh": [1, 2], "cfg": tp_cfg,
         "params": os.path.join(work, "tp_params.npz"),
         "audio": os.path.join(work, "tp_embeds.npz"), "kcap": 64, "steps": 4},
    ]
    procs = start_ranks({"cases": cases, "threads": 2}, work)
    try:
        refs = {"jax": {}, "port": {}}
        clips = serving_clips(6, seed=5)
        for kv8 in (False, True):
            j, t = _engines(moe_visible_model_dir, SERVE, "English", kv8)
            key = "serve_kv8" if kv8 else "serve"
            refs["jax"][key] = jserving.serve_continuous(j, clips, slots=4)
            refs["port"][key] = tserving.serve_continuous(t, clips, slots=4)
            if not kv8:
                refs["jax"]["segments"] = jbs.transcribe_segments_batched(j, segs)
                t.perf.reset()
                refs["port"]["segments"] = tbs.transcribe_segments_batched(t, segs)
                refs["port"]["segments_text_tokens"] = t.perf.text_tokens
                refs["jax"]["encode"] = np.asarray(jbs._encode_batch(
                    j, [jlog_mel(s) for s in segs])[0])
                refs["port"]["encode"] = tbs._encode_batch(t, [log_mel(s) for s in segs])
                refs["port"]["encode_device_mel"] = tbs._encode_batch_device_mel(t, segs)
        for kv8 in (False, True):
            j, t = _engines(stream_model, STREAM, kv8=kv8)
            key = "mstream_kv8" if kv8 else "mstream"
            for pkg, run, eng in (("jax", jms, j), ("port", tms, t)):
                with Spy() as spy:
                    texts = run.run_streams_batched(eng, streams)
                refs[pkg][key] = (texts, spy.log)
        refs["jax"]["tp_chunk"] = test_tp._run_meshed(tp=2, n_devices=2)
        refs["jax"]["tp1_chunk"] = test_tp._run_meshed(tp=1, n_devices=2)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = finish_ranks(procs, work, SPAWN_LIMIT_S)
    return ranks, refs


def _both(ranks, name):
    """The case's result on rank 0, after checking rank 1 saw the same texts."""
    r0, r1 = ranks[0][name], ranks[1][name]
    if "texts" in r0:
        assert r0["texts"] == r1["texts"], "the ranks disagree"
    return r0


@pytest.mark.parametrize("name", ["serve_dp", "serve_tp"])
def test_serving_on_the_mesh_matches_one_process_and_jax(runs, name):
    ranks, refs = runs
    got = _both(ranks, name)
    assert got["texts"] == refs["port"]["serve"] == refs["jax"]["serve"]
    assert any(got["texts"]), "comparison vacuous"
    assert got["perf"]["delta_prefills"] >= 2   # 6 clips through 4 slots: two waves
    # tp > 1 runs its batched step eagerly: nothing captured (the CPU never does)
    assert got["perf"]["graph_captures"] == 0


def test_kv8_serving_on_dp_matches(runs):
    ranks, refs = runs
    got = _both(ranks, "serve_kv8")
    assert got["texts"] == refs["port"]["serve_kv8"] == refs["jax"]["serve_kv8"]
    assert any(got["texts"])


def test_segments_with_a_pad_row(runs):
    """Three segments on a data axis of 2: one pad row, which gives no text
    and no perf counts."""
    ranks, refs = runs
    got = _both(ranks, "segments")
    assert got["texts"] == refs["port"]["segments"] == refs["jax"]["segments"]
    assert len(got["rows"]) == 3 and any(got["texts"])
    assert got["text_tokens"] == refs["port"]["segments_text_tokens"]
    assert got["perf"]["fresh_prefills"] == 1


def test_sp_group_encode_audio_rows(runs):
    ranks, refs = runs
    for rank in ranks:
        got = rank["encode"]["stack"]
        assert got.shape == refs["port"]["encode"][0].shape
        np.testing.assert_allclose(got, refs["port"]["encode"][0].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, refs["jax"]["encode"], rtol=0, atol=1e-6)
        assert rank["encode"]["n_tokens"] == refs["port"]["encode"][1]


def test_sp_group_encode_device_mel(runs):
    """The device front end under the encoder's SP: each data rank packs
    and log-mels its share of the three clips (one pad clip), the rows
    all-gathered equal one process's within the encoder parity tolerance."""
    ranks, refs = runs
    want, n_tokens = refs["port"]["encode_device_mel"]
    for rank in ranks:
        got = rank["encode_device_mel"]
        assert got["stack"].shape == tuple(want.shape) and got["n_tokens"] == n_tokens
        np.testing.assert_allclose(got["stack"], want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["mstream", "mstream_kv8"])
def test_multistream_on_dp_matches_per_chunk(runs, name):
    ranks, refs = runs
    got = _both(ranks, name)
    texts, chunks = refs["port"][name]
    assert (got["texts"], got["chunks"]) == (texts, chunks) == tuple(refs["jax"][name])
    assert any(any(c) for c in chunks), "no chunk decoded: vacuous"
    assert all(r["B"] >= 2 for r in got["rounds"])
    assert got["compactions"] >= 1    # rows moved between the data ranks


def test_eos_inside_a_chunk_on_one_ranks_rows(runs):
    """Rank 0's rows end at steps 2 and 5, rank 1's at 9 and 7: rank 0 stops
    replaying early, yet both ranks read one count and one buffer, and every
    row up to its EOS (what the host reads) is the single loop's."""
    ranks, _ = runs
    a, b = ranks[0]["loop_eos"], ranks[1]["loop_eos"]
    assert a["count"] == b["count"] == 10          # the last row's EOS at step 9
    assert a["replays"] == 6 and b["replays"] == 10
    assert np.array_equal(a["buf"], b["buf"]) and a["buf"].shape == (4, 10)
    eos = int(a["buf"][0, 2])
    for row, stop in enumerate([2, 5, 9, 7]):
        want = [1000 * (row + 1) + s for s in range(stop)] + [eos]
        assert a["buf"][row, : stop + 1].tolist() == want
    assert a["tokens_h"].tolist() == [eos] * 4


def test_tp_prefill_and_decode_chunk_match_jax_make_mesh(runs):
    ranks, refs = runs
    tok, buf = refs["jax"]["tp_chunk"]
    tok1, buf1 = refs["jax"]["tp1_chunk"]
    for rank in ranks:
        got = rank["tp_chunk"]
        assert np.array_equal(got["tokens"], tok) and np.array_equal(got["tokens"], tok1)
        assert np.array_equal(got["buf"][:, : got["count"]], buf[:, : got["count"]])
        assert np.array_equal(buf, buf1)
