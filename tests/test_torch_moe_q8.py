"""int8 experts (--q8 and the --spec draft on an MoE checkpoint) in the port
against the JAX package, on the CPU.

  * quantize_decoder(experts=True) on `tiny-moe` and `tiny-moe-mixed`, leaf
    by leaf against the JAX quantize_decoder carried over by
    params_from_jax: int8 values equal, scales within 1e-7 relative (both
    f32 divisions of the same maxima);
  * the MoE FFN on QuantW expert stacks (tests/test_q8.py:96-142's grid
    weights, each row's step a power of two of its own, so quantization
    is lossless and every row has its own scale) against the JAX `_moe_ffn` on the same int8 weights, within
    1e-4: the gather (T 1), the dense path (E 4), the capacity dispatch (E
    16, no drops), a forced overflow (the dispatch drops and falls back to
    dense) and the graph-safe forms, which read nothing back;
  * --q8 greedy tokens equal to the JAX engine's (q8=True), and --spec
    tokens equal to plain greedy and to the JAX engine's, across a SpecLoop
    chunk, on untied full-vocab checkpoints (every decoded id visible).
"""

import dataclasses

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
from smolvision_tpu.ops import quant as jq
from smolvision_tpu.runtime import prompt as jprompt
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.config import QWEN3_OMNI_30B as T_30B
from smolvision_tpu_torch.config import detect_config
from smolvision_tpu_torch.io.safetensors import MultiSafetensors
from smolvision_tpu_torch.models import moe
from smolvision_tpu_torch.models import params as tpm
from smolvision_tpu_torch.ops import quant as tq
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.runtime import decode_graph
from smolvision_tpu_torch.runtime import engine as teng_mod
from smolvision_tpu_torch.runtime import prompt as tprompt
from smolvision_tpu_torch.runtime.engine import Engine
from tests.test_torch_moe import _untied
from tests.test_torch_moe_offload import _greedy
from tests.test_torch_stream import speech

FFN_TOL = 1e-4
EXPERTS = ("e_gate", "e_up", "e_down")

# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("fixture", ["tiny_moe_model_dir", "tiny_moe_mixed_model_dir"])
def test_quantize_decoder_experts_match_jax(request, fixture):
    path = request.getfixturevalue(fixture)
    with JReader(path) as reader:
        jdec_q = jpm.quantize_decoder(jpm.load_decoder(reader, j_detect(path, reader),
                                                       jnp.float32))
        dec_np = jax.tree_util.tree_map(np.asarray, jdec_q)
    _, want = tpm.params_from_jax({}, dec_np, "cpu", torch.float32)
    with MultiSafetensors(path) as r:
        got = tpm.quantize_decoder(tpm.load_decoder(r, detect_config(path, r), torch.float32,
                                                    "cpu"))
    assert got["moe_layers"] == want["moe_layers"]
    a, b = dict(_flat(got)), dict(_flat(want))
    assert a.keys() == b.keys()
    for name in a:
        if name == "moe_layers":
            continue
        x, y = a[name], b[name]
        assert isinstance(x, tq.QuantW) == isinstance(y, tq.QuantW), name
        if isinstance(x, tq.QuantW):
            assert torch.equal(x.q, y.q), name
            torch.testing.assert_close(x.s, y.s, rtol=1e-7, atol=0, msg=name)
        else:
            assert torch.equal(x, y), name
    layers = got["layers"]
    for k in EXPERTS:
        assert isinstance(layers[k], tq.QuantW) and layers[k].q.dtype == torch.int8
        assert layers[k].s.shape == layers[k].q.shape[:-1]
    assert layers["router"].dtype == torch.float32
    assert got["lm_head"] is got["embed"]


# ---------------------------------------------------------------------------
# the FFN on int8 experts
# ---------------------------------------------------------------------------


def _grid(rng, shape):
    """Rows on an int8 grid, each row's max pinned at 127 and its step a
    power of two that differs from row to row (2^-5 .. 2^-8): lossless, and
    a scale applied on the wrong axis shows."""
    q = rng.integers(-127, 128, size=shape).astype(np.float32)
    q[..., 0] = 127.0
    rows = np.arange(int(np.prod(shape[:-1]))).reshape(shape[:-1])
    return q * (2.0 ** -(5 + rows % 4))[..., None]


# name: (T, E, biased router rows (every token prefers them), graph_safe,
#        whether the eager dispatch drops (None: no dispatch))
Q8_FFN_CASES = {
    "gather_T1_E4": (1, 4, (), False, None),
    "gather_T1_E4_graph_safe": (1, 4, (), True, None),
    "dense_T32_E4": (32, 4, (), False, None),
    "dispatch_T32_E16": (32, 16, (), False, False),
    "dense_T32_E16_graph_safe": (32, 16, (), True, False),
    "overflow_T64_E16": (64, 16, (0, 1), False, True),
    "overflow_T64_E16_graph_safe": (64, 16, (0, 1), True, True),
}


@pytest.mark.parametrize("name", sorted(Q8_FFN_CASES))
def test_moe_ffn_on_int8_experts_matches_jax(name):
    T, E, bias, graph_safe, drops = Q8_FFN_CASES[name]
    K, H, MI = 2, 32, 16
    kw = dict(num_experts=E, num_experts_per_tok=K, moe_intermediate=MI, norm_topk_prob=False)
    jcfg, tcfg = dataclasses.replace(J_30B, **kw), dataclasses.replace(T_30B, **kw)
    rng = np.random.default_rng(7 + T + E)
    router = rng.standard_normal((E, H)).astype(np.float32) * 0.1
    for i, e in enumerate(bias):
        router[e] += 3.0 - 0.5 * i
    w = {"e_gate": _grid(rng, (E, MI, H)), "e_up": _grid(rng, (E, MI, H)),
         "e_down": _grid(rng, (E, H, MI))}
    x = rng.standard_normal((T, H)).astype(np.float32)
    if bias:
        x = np.abs(x) + 0.1
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jlp = {"router": jnp.asarray(router),
           **{k: jq.quantize_weight(jnp.asarray(v)) for k, v in w.items()}}
    tlp = {"router": torch.from_numpy(router),
           **{k: tq.quantize_weight(torch.from_numpy(v)) for k, v in w.items()}}
    for k in EXPERTS:   # lossless on the grid: the same int8 values as JAX
        assert torch.equal(tlp[k].q, torch.from_numpy(np.array(jlp[k].q)))
    want = np.asarray(jdec._moe_ffn(jnp.asarray(x), jlp, jcfg))
    got = moe.moe_ffn(torch.from_numpy(x), tlp, tcfg, graph_safe=graph_safe)
    np.testing.assert_allclose(got.numpy(), want, rtol=FFN_TOL, atol=FFN_TOL)
    if drops is not None:   # the routing is the one the case names
        top_idx, top_w = moe.route(torch.from_numpy(x), tlp["router"], tcfg)
        out, n_dropped = moe.capacity_dispatch(torch.from_numpy(x).bfloat16(), tlp, top_idx,
                                               top_w, torch.ones(T, dtype=torch.bool))
        assert (int(n_dropped) > 0) == drops
        if not drops:   # the dispatch itself: scales on the queues' output axis
            np.testing.assert_allclose(out.numpy(), want, rtol=FFN_TOL, atol=FFN_TOL)


@pytest.mark.parametrize("T", [1, 4, 5, 64])
def test_int8_moe_graph_safe_reads_nothing(monkeypatch, T):
    """A graph step's forward on int8 experts (the --spec draft's gather
    with device indices at T <= 4, the dense form above) reads no tensor
    back to the host: every host read raises while it runs."""
    E, K, H, MI = 16, 2, 32, 16
    cfg = dataclasses.replace(T_30B, num_experts=E, num_experts_per_tok=K, moe_intermediate=MI)
    rng = np.random.default_rng(T)
    lp = {"router": torch.from_numpy(rng.standard_normal((E, H)).astype(np.float32)),
          **{k: tq.quantize_weight(torch.from_numpy(_grid(rng, s))) for k, s in
             (("e_gate", (E, MI, H)), ("e_up", (E, MI, H)), ("e_down", (E, H, MI)))}}
    x = torch.from_numpy(rng.standard_normal((T, H)).astype(np.float32))
    want = moe.moe_ffn(x, lp, cfg, graph_safe=True)

    def refuse(*a, **k):
        raise AssertionError("a host read inside a graph step's forward")

    for attr in ("item", "tolist", "cpu", "numpy", "__int__", "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    got = moe.moe_ffn(x, lp, cfg, graph_safe=True)
    monkeypatch.undo()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["tiny-moe", "tiny-moe-mixed"])
def q8_engines(request, tmp_path_factory):
    """On the untied f32 checkpoint of the preset: the JAX engine under --q8
    and under --spec, the port's engine under each and plain."""
    path = _untied(str(tmp_path_factory.mktemp("moe_q8") / request.param), request.param,
                   seed=11)
    engines = {"jax_q8": JEngine(path, param_dtype=jnp.float32, kv_dtype=jnp.float32, q8=True),
               "jax_spec": JEngine(path, param_dtype=jnp.float32, kv_dtype=jnp.float32,
                                   spec=True)}
    for name, kw in (("q8", dict(q8=True)), ("spec", dict(spec=True)), ("plain", {})):
        engines[name] = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32,
                               device="cpu", **kw)
    for eng in engines.values():
        eng.set_force_language("English")
    assert isinstance(engines["q8"].dec_params["layers"]["e_gate"], tq.QuantW)
    assert isinstance(engines["spec"].dec_params_draft["layers"]["e_down"], tq.QuantW)
    assert not isinstance(engines["spec"].dec_params["layers"]["e_down"], tq.QuantW)
    return engines


def test_q8_greedy_tokens_match_jax(q8_engines):
    audio = speech(3.0, seed=4)
    got = _greedy(q8_engines["q8"], tprompt, audio, 12)
    assert got == _greedy(q8_engines["jax_q8"], jprompt, audio, 12)
    assert len(set(got)) > 1


@pytest.mark.parametrize("max_tokens", [5, 24])
def test_spec_tokens_match_plain_and_jax(q8_engines, monkeypatch, max_tokens):
    """Chunks of 4 speculative iterations (DECODE_CHUNK patched down): 24
    tokens take more than one SpecLoop chunk, each read once; the tokens
    of every chunk are the plain greedy ones."""
    monkeypatch.setattr(decode_graph, "DECODE_CHUNK", 4)
    monkeypatch.setattr(teng_mod, "DECODE_CHUNK", 4)
    audio = speech(3.0, seed=5)

    def run(eng, prompt_mod):
        a, n = eng.encode_mel(log_mel(audio))
        ids, a0 = prompt_mod.build_asr_prompt(eng.cfg, n, eng._prompt_tokens, eng._force_tokens)
        eng.reset_kv()
        first, pos = eng.prefill_ids(ids, a, a0, n)
        out = []
        n = eng.decode_greedy(first, pos, max_tokens, lambda t: out.append(t) or True)
        return n, out

    spec = q8_engines["spec"]
    spec.perf.reset()
    got = run(spec, tprompt)
    assert got == run(q8_engines["plain"], tprompt)
    assert got == run(q8_engines["jax_spec"], jprompt)
    assert len(set(got[1])) > 1
    p = spec.perf
    assert p.spec_iters > 0 and p.decode_steps == teng_mod.SPEC_DRAFT * p.spec_iters
    assert p.spec_tokens == got[0] - 1
