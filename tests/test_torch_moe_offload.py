"""MoE host offload (--moe-offload, --moe-preload: models/moe_offload.py) in the
port, against the JAX package's offload engine and the port's resident
engine, on the CPU: every case of tests/test_moe_offload.py.

On untied full-vocab f32 checkpoints of `tiny-moe` and `tiny-moe-mixed`
(every decoded id visible):
  * the engine keeps no expert on the device, reads its experts from the
    checkpoint, and --moe-preload touches as many bytes as the JAX store;
  * prefill logits within 1e-5 (f32 on all sides, sums in another order)
    of the JAX offload engine's and the port's resident engine's, fresh
    and with KV reuse (a delta prefill at start > 0);
  * greedy tokens, transcribe_segment, one --stream (per chunk) and the
    greedy thinker equal to both, and one router read per MoE layer per
    decoded token;
  * the sampled thinker: the host Sampler per token, tokens equal to the
    JAX offload engine's for the same seed (and so the same on a rerun);
  * --q8 with offload: int8 resident weights, experts from the host in the
    checkpoint's dtype, tokens equal to the JAX engine's under both flags.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.runtime import prompt as jprompt
from smolvision_tpu.runtime import stream as jstream
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.models import moe_offload
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.ops.quant import QuantW
from smolvision_tpu_torch.runtime import prompt as tprompt
from smolvision_tpu_torch.runtime import stream as tstream
from smolvision_tpu_torch.runtime.engine import Engine
from tests.test_torch_moe import _untied
from tests.test_torch_stream import speech, stream_chunks
from tests.test_torch_thinker import _thinker_ids

TOL = 1e-5
PRESETS = ["tiny-moe", "tiny-moe-mixed"]


@pytest.fixture(scope="module", params=PRESETS)
def engines(request, tmp_path_factory):
    """(JAX offload engine, port offload engine, port resident engine, model
    dir) on the untied f32 checkpoint of the preset."""
    path = _untied(str(tmp_path_factory.mktemp("moe_off") / request.param), request.param,
                   seed=12)
    j = JEngine(path, param_dtype=jnp.float32, kv_dtype=jnp.float32, moe_offload=True)
    off = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu",
                 moe_offload=True)
    res = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu")
    for eng in (j, off, res):
        eng.set_force_language("English")
        eng.max_tokens = 10
    return j, off, res, path


def _greedy(eng, prompt_mod, audio, max_tokens=12):
    """The greedy tokens after the clip's ASR prompt (the JAX offload
    test's 12)."""
    ids, a, a0, n = _prompt(eng, prompt_mod, audio)
    eng.reset_kv()
    first, pos = eng.prefill_ids(ids, a, a0, n)
    got = []
    eng.decode_greedy(first, pos, max_tokens, lambda t: got.append(t) or True)
    return got


def _prompt(eng, prompt_mod, audio):
    a, n = eng.encode_mel(log_mel(audio))
    ids, a0 = prompt_mod.build_asr_prompt(eng.cfg, n, eng._prompt_tokens, eng._force_tokens)
    return ids, a, a0, n


def test_offload_engine_setup(engines):
    j, off, res, _ = engines
    assert off.moe_offload and not res.moe_offload
    layers = off.dec_params["layers"]
    assert all(layers[k] is None for k in ("e_gate", "e_up", "e_down"))
    assert layers["router"].dtype == torch.float32
    assert not off.batch_segments and res.batch_segments
    store = off.expert_store
    assert store.is_moe == j.expert_store.is_moe == list(off.dec_params["moe_layers"])
    for li, moe in enumerate(store.is_moe):   # a mixed stack's dense layers have no rows
        assert (store._views[li] is not None) == moe
    touched = store.preload()
    assert touched == j.expert_store.preload() > 0


def test_offload_prefill_logits_match(engines):
    j, off, res, _ = engines
    audio = speech(3.0, seed=3)
    out = []
    for eng, prompt_mod in ((j, jprompt), (off, tprompt), (res, tprompt)):
        ids, a, a0, n = _prompt(eng, prompt_mod, audio)
        eng.reset_kv()
        logits, _ = eng.prefill_ids(ids, a, a0, n, greedy=False)
        out.append(np.asarray(logits))
    np.testing.assert_allclose(out[1], out[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out[1], out[2], rtol=TOL, atol=TOL)


def test_offload_greedy_decode_matches(engines):
    """Prefill, then the per-token host loop (the gather of the chosen
    experts), one router read per MoE layer per step."""
    j, off, res, _ = engines
    audio = speech(3.0, seed=2)
    store = off.expert_store
    reads, steps = store.stats["router_reads"], off.perf.decode_steps
    got = _greedy(off, tprompt, audio)
    n_moe = sum(store.is_moe)
    assert store.stats["router_reads"] - reads == n_moe * (off.perf.decode_steps - steps)
    assert off.perf.decode_steps - steps == len(got) - 1
    assert got == _greedy(j, jprompt, audio) == _greedy(res, tprompt, audio)
    assert len(set(got)) > 1


def test_offload_kv_reuse_matches(engines):
    """The stream's delta prefill (prefill_with_reuse at start > 0)."""
    j, off, res, _ = engines
    audio = speech(3.0, seed=4)
    outs = []
    for eng, prompt_mod in ((j, jprompt), (off, tprompt), (res, tprompt)):
        ids, a, a0, n = _prompt(eng, prompt_mod, audio)
        ext = list(ids) + [100, 200, 300]
        eng.reset_kv()
        eng.prefill_ids(ids, a, a0, n, greedy=False)
        out, total = eng.prefill_with_reuse(ext, a, a0, n, reused=len(ids), greedy=False)
        assert total == len(ext)
        outs.append(np.asarray(out))
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs[1], outs[2], rtol=TOL, atol=TOL)


def test_offload_transcribe_segment_matches(engines):
    j, off, res, _ = engines
    audio = speech(3.0, seed=5)
    got = off.transcribe_segment(audio)
    assert got == j.transcribe_segment(audio) == res.transcribe_segment(audio)
    assert got[1] > 0


def test_offload_stream_per_chunk_matches(engines):
    """One --stream: each chunk's delta prefill at start > 0 (KV reuse) and
    its greedy tokens, per chunk, equal to the JAX offload engine's and
    the port's resident engine's."""
    j, off, res, _ = engines
    audio = speech(7.0, seed=1)
    for eng in (j, off, res):
        eng.stream_max_new_tokens = 6
        eng.past_text_conditioning = True
    got = stream_chunks(tstream, off, audio)
    assert got == stream_chunks(jstream, j, audio) == stream_chunks(tstream, res, audio)
    assert any(reused > 0 for _, reused, _, _ in got[0]) and got[1]


def test_offload_thinker_greedy_matches(engines):
    j, off, res, _ = engines
    settings = dict(temperature=0.0, thinker_max_tokens=12)
    got = _thinker_ids(off, **settings)
    assert got == _thinker_ids(j, **settings) == _thinker_ids(res, **settings)
    assert len(got) == 12


def test_offload_thinker_sampled_matches_jax(engines):
    """The host Sampler per token (temperature, top-k, repetition penalty,
    the seeded draw): the JAX offload engine's tokens for the same seed."""
    j, off, _, _ = engines
    settings = dict(temperature=0.7, top_k=8, seed=123, thinker_max_tokens=12)
    got = _thinker_ids(off, **settings)
    assert got == _thinker_ids(j, **settings) == _thinker_ids(off, **settings)
    assert len(got) == 12 and len(set(got)) > 1


def test_offload_with_q8_matches_jax(engines):
    """--moe-offload with --q8: the resident matrices are int8 (a mixed
    stack's dense FFN too), the experts come from the host in the
    checkpoint's dtype; tokens equal to the JAX engine's under both."""
    path = engines[3]
    off = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu",
                 moe_offload=True, q8=True)
    j = JEngine(path, param_dtype=jnp.float32, kv_dtype=jnp.float32, moe_offload=True, q8=True)
    layers = off.dec_params["layers"]
    assert off.moe_offload and off.q8 and not off.spec
    assert isinstance(layers["wqkv"], QuantW) and isinstance(off.dec_params["lm_head"], QuantW)
    assert layers["e_gate"] is None and off.expert_store.dtype == torch.float32
    if not all(off.dec_params["moe_layers"]):   # the mixed stack's dense FFN
        assert isinstance(layers["w_gate_up"], QuantW)
    audio = speech(3.0, seed=6)
    got = _greedy(off, tprompt, audio)
    assert got == _greedy(j, jprompt, audio) and len(set(got)) > 1


def test_topk_desc_is_stable_and_descending():
    scores = np.array([0.5, 2.0, 0.5, 3.0, 2.0, -1.0], np.float32)
    assert moe_offload._topk_desc(scores, 4).tolist() == [3, 1, 4, 0]


def test_spec_off_under_offload(engines, capfd):
    _, _, _, path = engines
    eng = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu",
                 moe_offload=True, spec=True)
    assert eng.moe_offload and not eng.spec and eng.dec_params_draft is None
    assert "--spec disabled" in capfd.readouterr().err
