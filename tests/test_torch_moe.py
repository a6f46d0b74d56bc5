"""MoE decoders (Qwen3-Omni-30B-A3B's) in the port against the JAX package,
on the CPU.

  * The FFN (models/moe.py) against the JAX `_moe_ffn` and
    `_moe_capacity_dispatch` on inputs drawn with numpy, within 1e-5 in f32
    (both sides f32, the sums in another order), at E 16 / K 2 and at the
    30B's E 128 / K 8 with small H and MI: the gather at T 1-4, dispatch
    without drops, dispatch with drops (the dense fallback), adversarial
    imbalance, pad rows that must not crowd out real tokens,
    norm_topk_prob on and off, and the graph-safe form (a graph step's
    forward, which never reads the drop count) on overflowing routings.
  * The loader on `tiny-moe` and `tiny-moe-mixed` against params_from_jax
    of the JAX loader, and the port's synthetic presets byte-identical to
    the tool's.
  * On untied full-vocab checkpoints (streams commit text, every decoded
    id is visible): greedy tokens, -S, --serve, one --stream, multistream
    and the thinker (greedy, and sampled at top-k 1) equal to the JAX
    engine's on `tiny-moe` and `tiny-moe-mixed`; on a 16-expert checkpoint,
    where the eager forwards dispatch and the graph steps take the dense
    form, offline, -S at B 5 and --serve equal to the JAX engine's.
  * The CLI: --f32 stdout byte-equal to the JAX CLI's (the JAX cases in one
    subprocess), also under --q8, --spec, --moe-offload (with
    --moe-preload, and the sampled thinker); several -i files under
    --moe-offload one line, exit 1.
"""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from smolvision_tpu.config import QWEN3_OMNI_30B as J_30B
from smolvision_tpu.config import detect_config as j_detect
from smolvision_tpu.io.safetensors import MultiSafetensors as JReader
from smolvision_tpu.models import params as jpm
from smolvision_tpu.models import qwen3_decoder as jdec
from smolvision_tpu.runtime import batch_segments as jbs
from smolvision_tpu.runtime import prompt as jprompt
from smolvision_tpu.runtime import serving as jserving
from smolvision_tpu.runtime import stream as jstream
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.config import QWEN3_OMNI_30B as T_30B
from smolvision_tpu_torch.config import detect_config
from smolvision_tpu_torch.io.safetensors import MultiSafetensors, write_safetensors
from smolvision_tpu_torch.models import moe
from smolvision_tpu_torch.models import params as tpm
from smolvision_tpu_torch.models import synthetic
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.runtime import batch_segments as tbs
from smolvision_tpu_torch.runtime import prompt as tprompt
from smolvision_tpu_torch.runtime import serving as tserving
from smolvision_tpu_torch.runtime import stream as tstream
from smolvision_tpu_torch.runtime.engine import Engine
from tests.test_torch_engine import _wav_bytes
from tests.test_torch_multistream import check_against_jax_and_solo, nonvacuous
from tests.test_torch_stream import speech, stream_chunks
from tests.test_torch_thinker import _thinker_ids, jax_cli_batch, port_cli
from tests.workloads import serving_clips

ATOL = RTOL = 1e-5

# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------


def _cfgs(E, K, MI, norm):
    kw = dict(num_experts=E, num_experts_per_tok=K, moe_intermediate=MI, norm_topk_prob=norm)
    return dataclasses.replace(J_30B, **kw), dataclasses.replace(T_30B, **kw)


def _layer(E, H, MI, seed, bias=()):
    """One MoE layer's f32 weights as numpy: router rows of one norm (no
    expert favoured: random tokens spread evenly); `bias` adds 3.0 - 0.5 i
    to router row i (every token then prefers those experts)."""
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((E, H)).astype(np.float32)
    router *= 0.1 / np.linalg.norm(router, axis=1, keepdims=True)
    for i, e in enumerate(bias):
        router[e] += 3.0 - 0.5 * i
    return {"router": router,
            "e_gate": rng.standard_normal((E, MI, H)).astype(np.float32) * 0.1,
            "e_up": rng.standard_normal((E, MI, H)).astype(np.float32) * 0.1,
            "e_down": rng.standard_normal((E, H, MI)).astype(np.float32) * 0.1}


def _both(lp):
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v) for k, v in lp.items()})


# name: (E, K, T, norm_topk_prob, biased router rows, pad rows, graph_safe,
#        whether the eager dispatch drops)
FFN_CASES = {
    "gather_T1_E16": (16, 2, 1, True, (), 0, False, None),
    "gather_T2_E128": (128, 8, 2, True, (), 0, False, None),
    "gather_T3_E16_no_norm": (16, 2, 3, False, (), 0, False, None),
    "gather_T4_E128": (128, 8, 4, True, (), 0, True, None),
    "dispatch_balanced_E16": (16, 2, 48, True, (), 0, False, False),
    "dispatch_balanced_E128": (128, 8, 512, True, (), 0, False, False),
    "dispatch_drops_E128": (128, 8, 64, True, (5, 9, 11, 20, 31, 40, 77, 100), 0, False, True),
    "adversarial_E16": (16, 2, 64, True, (0, 1), 0, False, True),
    "adversarial_E16_no_norm": (16, 2, 64, False, (0, 1), 0, False, True),
    "pads_E16": (16, 2, 64, True, (3,), 56, False, False),
    "graph_safe_overflow_E16": (16, 2, 64, True, (0, 1), 0, True, True),
    "graph_safe_overflow_E128": (128, 8, 64, True, (5, 9, 11, 20, 31, 40, 77, 100), 8, True,
                                 True),
    "dense_E4": (4, 2, 16, True, (), 0, False, None),
}


@pytest.mark.parametrize("name", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(name):
    E, K, T, norm, bias, n_pad, graph_safe, drops = FFN_CASES[name]
    H, MI = 32, 16
    jcfg, tcfg = _cfgs(E, K, MI, norm)
    lp = _layer(E, H, MI, seed=len(name), bias=bias)
    rng = np.random.default_rng(T)
    x = (np.abs(rng.standard_normal((T, H))) + 0.1 if bias
         else rng.standard_normal((T, H))).astype(np.float32)
    valid = np.arange(T) >= n_pad
    jlp, tlp = _both(lp)
    want = np.asarray(jdec._moe_ffn(jnp.asarray(x), jlp, jcfg, valid=jnp.asarray(valid)))
    got = moe.moe_ffn(torch.from_numpy(x), tlp, tcfg, torch.from_numpy(valid),
                      graph_safe=graph_safe)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if drops is not None:   # the routing is the one the case names
        top_idx, top_w = moe.route(torch.from_numpy(x), tlp["router"], tcfg)
        _, n_dropped = moe.capacity_dispatch(torch.from_numpy(x), tlp, top_idx, top_w,
                                             torch.from_numpy(valid))
        assert (int(n_dropped) > 0) == drops


def test_moe_graph_safe_reads_no_drop_count(monkeypatch):
    """A graph step's forward never runs the dispatch (whose drop count the
    eager forward reads on the host); an eager one over E >= 16 does."""
    jcfg, tcfg = _cfgs(16, 2, 16, True)
    _, tlp = _both(_layer(16, 32, 16, seed=1))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32))
    calls = []
    real = moe.capacity_dispatch
    monkeypatch.setattr(moe, "capacity_dispatch", lambda *a: calls.append(1) or real(*a))
    moe.moe_ffn(x, tlp, tcfg, graph_safe=True)
    assert calls == []
    moe.moe_ffn(x, tlp, tcfg)
    assert calls == [1]


@pytest.mark.parametrize("case", ["balanced", "overflow", "pads"])
def test_capacity_dispatch_matches_jax(case):
    """The dispatch itself against the JAX one on given routings: a balanced
    round-robin (no drops), everything to expert 0 (the first C tokens
    kept, the drop count the rest), and 56 pad rows before 8 real tokens
    that all want expert 0 (pads take no rank: no drops, pads get 0)."""
    T, E, H, MI = 64, 16, 32, 16
    K = 2 if case == "balanced" else 1
    jcfg, tcfg = _cfgs(E, K, MI, False)
    lp = _layer(E, H, MI, seed=4)
    lp.pop("router")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, H)).astype(np.float32)
    if case == "balanced":
        top_idx = np.array([[(t * K + k) % E for k in range(K)] for t in range(T)], np.int32)
    else:
        top_idx = np.zeros((T, K), np.int32)
    top_w = rng.random((T, K)).astype(np.float32)
    valid = np.arange(T) >= (56 if case == "pads" else 0)
    jlp, tlp = _both(lp)
    want, j_drop = jdec._moe_capacity_dispatch(jnp.asarray(x), jlp, jnp.asarray(top_idx),
                                               jnp.asarray(top_w), jcfg, jnp.asarray(valid))
    got, t_drop = moe.capacity_dispatch(torch.from_numpy(x), tlp,
                                        torch.from_numpy(top_idx).long(),
                                        torch.from_numpy(top_w), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert int(t_drop) == int(j_drop) == {"balanced": 0, "overflow": T - 8, "pads": 0}[case]
    if case == "pads":
        assert not got[:56].any() and (got[56:].abs().sum(-1) > 0).all()


# ---------------------------------------------------------------------------
# the loader and the presets
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("fixture,moe_layers", [
    ("tiny_moe_model_dir", (True, True)),
    ("tiny_moe_mixed_model_dir", (False, True, False, True))])
def test_load_decoder_matches_params_from_jax(request, fixture, moe_layers):
    """Per layer the MoE rows of the expert stacks and the dense rows of a
    mixed stack's FFN; the router f32 under bf16 weights."""
    path = request.getfixturevalue(fixture)
    with JReader(path) as reader:
        dec_np = jax.tree_util.tree_map(np.asarray, jpm.load_decoder(
            reader, j_detect(path, reader), jnp.bfloat16))
    _, dec_a = tpm.params_from_jax({}, dec_np, "cpu", torch.bfloat16)
    with MultiSafetensors(path) as r:
        dec_b = tpm.load_decoder(r, detect_config(path, r), torch.bfloat16, "cpu")
    assert dec_a["moe_layers"] == dec_b["moe_layers"] == moe_layers
    a, b = dict(_flat(dec_a)), dict(_flat(dec_b))
    assert a.keys() == b.keys()
    for name in a:
        if name != "moe_layers":
            assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name
    layers = dec_b["layers"]
    n_moe = sum(moe_layers)
    assert layers["router"].dtype == torch.float32 and layers["router"].shape[0] == n_moe
    assert layers["e_gate"].shape == (n_moe, 4, 32, 48) and layers["e_down"].shape == (
        n_moe, 4, 48, 32)
    assert ("w_gate_up" in layers) == (not all(moe_layers))


@pytest.mark.parametrize("preset", ["tiny-moe", "tiny-moe-mixed"])
def test_moe_presets_are_byte_identical(tmp_path, preset):
    from tools.make_tiny_model import build

    a = build(preset, str(tmp_path / "tool"), seed=3, dtype="bf16", full_vocab=True)
    b = synthetic.build(preset, str(tmp_path / "port"), seed=3, dtype="bf16", full_vocab=True)
    for name in ("model.safetensors", "config.json", "vocab.json", "merges.txt"):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


# ---------------------------------------------------------------------------
# the paths, on untied full-vocab checkpoints
# ---------------------------------------------------------------------------

MOE16 = dict(synthetic.PRESETS["tiny-moe"], moe=dict(num_experts=16, top_k=4, moe_inter=32))


def _untied(model_dir: str, preset: str, seed: int) -> str:
    """`preset` (f32, full vocab) with a separate random lm_head: a tied
    random head greedy-decodes one token over and over."""
    synthetic.build(preset, model_dir, seed=seed, dtype="f32", full_vocab=True)
    with MultiSafetensors(model_dir) as r:
        tensors = {k: r.get(k).clone() for k in r.names()}
    embed = tensors["thinker.model.embed_tokens.weight"]
    tensors["thinker.lm_head.weight"] = torch.from_numpy(
        np.random.default_rng(seed + 1000).normal(0, 0.1, embed.shape).astype(np.float32))
    write_safetensors(os.path.join(model_dir, "model.safetensors"), tensors)
    path = os.path.join(model_dir, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["thinker_config"]["text_config"]["tie_word_embeddings"] = False
    with open(path, "w") as f:
        json.dump(cfg, f)
    return model_dir


ALL = pytest.mark.parametrize("engines", ["tiny-moe", "tiny-moe-mixed", "moe16"],
                              indirect=True)
TINY = pytest.mark.parametrize("engines", ["tiny-moe", "tiny-moe-mixed"], indirect=True)


@pytest.fixture(scope="module")
def engines(request, tmp_path_factory):
    """(JAX engine, port engine, model dir) on the untied checkpoint of
    the preset, f32 weights and cache."""
    preset = request.param
    path = str(tmp_path_factory.mktemp("moe") / preset)
    if preset == "moe16":
        with pytest.MonkeyPatch.context() as m:
            m.setitem(synthetic.PRESETS, "moe16", MOE16)
            _untied(path, "moe16", seed=6)
    else:
        _untied(path, preset, seed=6)
    j = JEngine(path, param_dtype=jnp.float32, kv_dtype=jnp.float32)
    t = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu")
    for eng in (j, t):
        eng.max_tokens = 8
        eng.stream_max_new_tokens = 6
        eng.past_text_conditioning = True
        eng.set_force_language("English")
    return j, t, path


def _greedy(eng, prompt_mod, audio):
    a, n = eng.encode_mel(log_mel(audio))
    ids, a0 = prompt_mod.build_asr_prompt(eng.cfg, n, (), ())
    eng.reset_kv()
    first, pos = eng.prefill_ids(ids, a, a0, n)
    got = []
    eng.decode_greedy(first, pos, 24, lambda t: got.append(t) or True)
    return got


@ALL
def test_greedy_tokens_match_jax(engines):
    jeng, teng, _ = engines
    audio = speech(3.0, seed=2)
    want = _greedy(jeng, jprompt, audio)
    got = _greedy(teng, tprompt, audio)
    assert got == want and len(set(got)) > 1


@ALL
def test_segments_batched_match_jax(engines):
    """-S: the batched fresh prefill (an eager forward over B * T rows) and
    the batched decode step at B 5 (graph-safe above 4 rows)."""
    jeng, teng, _ = engines
    rng = np.random.default_rng(9)
    segs = [(rng.standard_normal(16000 * (1 + i % 3)) * 0.2).astype(np.float32)
            for i in range(5)]
    want = jbs.transcribe_segments_batched(jeng, segs)
    got = tbs.transcribe_segments_batched(teng, segs)
    assert got == want and any(got)


@ALL
def test_serving_matches_jax(engines):
    """--serve: admission waves (eager delta prefills against the cache,
    natural layout) and the batched decode step."""
    jeng, teng, _ = engines
    clips = serving_clips(5, seed=7)
    want = jserving.serve_continuous(jeng, clips, slots=2)
    got = tserving.serve_continuous(teng, clips, slots=2)
    assert got == want and any(got)


@TINY
def test_stream_per_chunk_matches_jax(engines):
    jeng, teng, _ = engines
    want = stream_chunks(jstream, jeng, speech(9.0, seed=1))
    got = stream_chunks(tstream, teng, speech(9.0, seed=1))
    assert got == want and got[1]


@TINY
def test_multistream_matches_jax_and_solo(engines, monkeypatch):
    jeng, teng, _ = engines
    texts, per = check_against_jax_and_solo(
        monkeypatch, {"jax": jeng, "torch": teng},
        [speech(float(s), seed=20 + i) for i, s in enumerate((3, 4))])
    nonvacuous(per, texts)


@TINY
@pytest.mark.parametrize("top_k,temperature", [(1, 0.7), (40, 0.0)])
def test_thinker_matches_jax(engines, top_k, temperature):
    """Sampled at top-k 1 (SampleLoop's draw is the argmax) and greedy."""
    jeng, teng, _ = engines
    settings = dict(top_k=top_k, temperature=temperature, thinker_max_tokens=40)
    want = _thinker_ids(jeng, **settings)
    got = _thinker_ids(teng, **settings)
    assert got == want and len(got) == 40


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_CASES = {
    "offline": ["-i", "WAV", "--max-tokens", "12"],
    "segments": ["-i", "WAV", "-S", "1", "-W", "0.4", "--max-tokens", "8"],
    "thinker": ["--thinker", "--text", "hi", "--temperature", "0", "--max-tokens", "12"],
    "q8": ["-i", "WAV", "--q8", "--max-tokens", "12"],
    "spec": ["-i", "WAV", "--spec", "--max-tokens", "12"],
    "moe_offload": ["-i", "WAV", "--moe-offload", "--max-tokens", "12"],
    "moe_offload_preload": ["-i", "WAV", "-S", "1", "-W", "0.4", "--moe-offload",
                            "--moe-preload", "--max-tokens", "8"],
    "thinker_moe_offload": ["--thinker", "--text", "hi", "--moe-offload", "--max-tokens", "12"],
}


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_cli")
    path = _untied(str(d / "model"), "tiny-moe-mixed", seed=8)
    wav = d / "clip.wav"
    wav.write_bytes(_wav_bytes(speech(3.0, seed=7)))
    argvs = {c: ["-d", path, "--f32", "--language", "English"]
             + [str(wav) if a == "WAV" else a for a in args] for c, args in CLI_CASES.items()}
    return path, str(wav), argvs


@pytest.fixture(scope="module")
def jax_cli(cli_model):
    cases = sorted(CLI_CASES)
    return dict(zip(cases, jax_cli_batch([cli_model[2][c] for c in cases])))


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_stdout_byte_equal(cli_model, jax_cli, case):
    j_rc, j_out, _ = jax_cli[case]
    t_rc, t_out, t_err = port_cli(cli_model[2][case])
    assert t_rc == j_rc == 0, t_err
    assert t_out == j_out and t_out.strip()


@pytest.mark.parametrize("extra", [[], ["--serve", "2"], ["--stream"]])
def test_cli_several_files_under_moe_offload_exit_1(cli_model, extra):
    """The batched paths (a static batch, --serve, multistream) read the
    expert stacks, which --moe-offload leaves on the host: one line, exit 1."""
    path, wav, _ = cli_model
    rc, out, err = port_cli(["-d", path, "--silent", "--moe-offload", "-i", wav, wav] + extra)
    lines = err.strip().splitlines()
    assert rc == 1 and out == b"" and len(lines) == 1
    assert lines[0].startswith("smolvision: --moe-offload") and "several -i" in lines[0]
