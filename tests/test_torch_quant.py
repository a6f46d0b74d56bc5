"""The port's int8 paths (--q8 weights, --kv8 batched cache) and its greedy-head
and probe kernels' plain versions, against the JAX package on the CPU.

Tolerances:
  * quantize_weight / quantize_kv_rows: bit-equal (f32 division, then
    round-half-to-even on both sides);
  * proj, int8 x int8 branch (>= 1024 rows): 1e-6 relative -- the int32
    product is exact, only the two f32 scale multiplications remain;
  * proj, dequantized branch: 1e-5 relative -- bf16 x bf16 products are
    exact in f32, only the summation order differs;
  * embed_rows and the cache plumbing (grow, admit): exact;
  * the batched attention with an int8 cache: 1e-5 relative, against the
    JAX package's f32 (non-TPU) branch, which folds the scales into the
    scores and probabilities where the port widens the rows first;
  * argmax and read_all plain versions against the tools/ Pallas probes in
    interpret mode: equal indices and values.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from smolvision_tpu.models import params as jpm
from smolvision_tpu.models import qwen3_decoder as jdec
from smolvision_tpu.ops import quant as jq
from smolvision_tpu.parallel import batch as jbatch
from smolvision_tpu.runtime import batch_segments as jbs
from smolvision_tpu.runtime import prompt as jprompt
from smolvision_tpu.runtime import serving as jserving
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.kernels import argmax_matvec as tam
from smolvision_tpu_torch.kernels import flash_attention as tfa
from smolvision_tpu_torch.kernels import probes as tprobes
from smolvision_tpu_torch.models import params as tpm
from smolvision_tpu_torch.models import qwen3_decoder as tdec
from smolvision_tpu_torch.ops import quant as tq
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.parallel import batch as tbatch
from smolvision_tpu_torch.runtime import batch_segments as tbs
from smolvision_tpu_torch.runtime import prompt as tprompt
from smolvision_tpu_torch.runtime import serving as tserving
from smolvision_tpu_torch.runtime.engine import Engine
from tests.workloads import serving_clips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid_rows(rng, shape, scale=2.0 ** -6):
    """Rows exactly on the int8 x 2^-6 grid with each row's max pinned at
    127 (tests/test_q8.py:_grid_weight): quantization is lossless."""
    q = rng.integers(-127, 128, size=shape).astype(np.float32)
    q[..., 0] = 127.0
    return q * scale


def _as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# quantization: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random_f32", "random_bf16", "lossless"])
def test_quantize_weight_and_kv_rows_bit_equal(kind):
    rng = np.random.default_rng(0)
    if kind == "lossless":
        w = _grid_rows(rng, (64, 48))
    else:
        w = (rng.standard_normal((300, 128)) * 0.05).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if kind == "random_bf16":
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    for jfn, tfn in ((jq.quantize_weight, tq.quantize_weight),
                     (jq.quantize_kv_rows, tq.quantize_kv_rows)):
        want, got = jfn(jw), tfn(tw)
        assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    if kind == "lossless":
        got = tq.quantize_weight(tw)
        np.testing.assert_array_equal((got.q.float() * got.s[:, None]).numpy(), w)
        assert got.dtype == torch.bfloat16   # activations are cast to bf16 for it


def test_quantize_decoder_keeps_a_tied_head_one_quantw(tiny_model_dir):
    from smolvision_tpu_torch.io.safetensors import MultiSafetensors
    from smolvision_tpu_torch.config import detect_config

    with MultiSafetensors(tiny_model_dir) as r:
        cfg = detect_config(tiny_model_dir, r)
        params = tpm.load_decoder(r, cfg, torch.float32, "cpu")
    assert params["lm_head"] is params["embed"]
    qp = tpm.quantize_decoder(params)
    assert isinstance(qp["embed"], tq.QuantW) and qp["lm_head"] is qp["embed"]
    assert all(isinstance(qp["layers"][k], tq.QuantW)
               for k in ("wqkv", "wo", "w_gate_up", "w_down"))
    assert qp["layers"]["input_ln"] is params["layers"]["input_ln"]
    # the same leaves as the JAX package's quantize_decoder
    jemb = jnp.asarray(params["embed"].numpy())
    jp = jpm.quantize_decoder({"embed": jemb, "lm_head": jemb,
                               "layers": {"wo": jnp.asarray(params["layers"]["wo"].numpy())}})
    for got, want in ((qp["embed"], jp["embed"]), (qp["layers"]["wo"], jp["layers"]["wo"])):
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


# ---------------------------------------------------------------------------
# proj and embed_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,eq,rtol", [
    (5, "th,oh->to", 1e-5),          # dequantized branch (a decode block)
    (1, "bh,vh->bv", 1e-5),
    (1100, "th,oh->to", 1e-6),       # int8 x int8 branch (>= 1024 rows)
    (1100, "ti,hi->th", 1e-6),
])
def test_proj_matches_jax(M, eq, rtol):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((96, 128)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, 128)).astype(np.float32)
    want = np.asarray(jq.proj(eq, jnp.asarray(x, jnp.bfloat16), jq.quantize_weight(jnp.asarray(w))))
    got = tq.proj(torch.from_numpy(x), tq.quantize_weight(torch.from_numpy(w))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def test_proj_batched_rows_collapse_like_jax():
    """A batched block [B, T, H] takes the int8 x int8 branch on its B * T
    collapsed rows, as the JAX package's bth,oh->bto equation does."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    x = rng.standard_normal((4, 300, 96)).astype(np.float32)
    want = np.asarray(jq.proj("bth,oh->bto", jnp.asarray(x, jnp.bfloat16),
                              jq.quantize_weight(jnp.asarray(w))))
    got = tq.proj(torch.from_numpy(x), tq.quantize_weight(torch.from_numpy(w))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_embed_rows_exact():
    rng = np.random.default_rng(3)
    emb = (rng.standard_normal((500, 64)) * 0.05).astype(np.float32)
    ids = rng.integers(0, 500, (3, 17))
    for table_j, table_t in ((jnp.asarray(emb), torch.from_numpy(emb)),
                             (jq.quantize_weight(jnp.asarray(emb)),
                              tq.quantize_weight(torch.from_numpy(emb)))):
        want = np.asarray(jq.embed_rows(table_j, jnp.asarray(ids)))
        got = tq.embed_rows(table_t, torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the int8 cache plumbing: exact
# ---------------------------------------------------------------------------

def _quant_cache(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jq.quantize_kv_rows(jnp.asarray(x)), tq.quantize_kv_rows(torch.from_numpy(x))


def _assert_same_kv(got, want):
    assert isinstance(got, tq.QuantKV)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


def test_kv_grow_and_admit_on_quantkv():
    rng = np.random.default_rng(4)
    shape = (2, 2, 3, 2, 16, 8)                     # [L, 2, B, KH, K, D]
    jkv, tkv = _quant_cache(rng, shape)
    _assert_same_kv(tq.kv_grow_k(tkv, 40), jq.kv_grow_k(jkv, 40))
    big_j, big_t = _quant_cache(rng, (2, 2, 4, 2, 24, 8))
    small_j, small_t = _quant_cache(rng, shape)
    want = jbatch.admit_rows(big_j, small_j, [3, 1], 2, src=[2, 0])
    got = tbatch.admit_rows(big_t, small_t, [3, 1], 2, src=[2, 0])
    _assert_same_kv(got, want)
    assert got.q is big_t.q and got.s is big_t.s   # in place


def test_make_batched_kv_int8_is_quantized(tiny_model_dir):
    eng = Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                 device="cpu", kv8=True)
    kv = tbatch.make_batched_kv(eng.cfg, 2, 64, eng.batched_kv_dtype, eng.device)
    assert isinstance(kv, tq.QuantKV) and kv.dtype == torch.int8 and kv.shape[4] == 64
    assert kv.s.shape == kv.q.shape[:-1] and kv.s.dtype == torch.float32
    with pytest.raises(ValueError, match="batched-path only"):
        tdec.decoder_forward(eng.dec_params, eng.cfg, torch.zeros(1, eng.cfg.dec_hidden), 0, 1,
                             kv)


@pytest.mark.parametrize("T,start,natural", [(1, 28, False), (1, 28, True), (16, 12, False),
                                             (16, 0, False)])
def test_batched_attention_kv8_matches_jax(T, start, natural):
    from smolvision_tpu.config import ModelConfig

    cfg = ModelConfig(dec_hidden=64, dec_layers=2, dec_heads=4, dec_kv_heads=2,
                      dec_head_dim=16, dec_intermediate=96)
    B, H, KH, D, K = 3, 4, 2, 16, 48
    rng = np.random.default_rng(5)
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, D), (B, T, KH, D), (B, T, KH, D)))
    (kj, kt), (vj, vt) = (_quant_cache(rng, (B, KH, K, D)) for _ in range(2))
    kv_min = np.asarray([0, 3, 7], np.int32)
    extra = {}
    if natural:
        extra = dict(prompt_max=np.asarray([10, 20, 5], np.int32),
                     region_start=np.asarray([22, 25, 20], np.int32))
    want = jdec._batched_attention_two_part(
        *map(jnp.asarray, (q, kn, vn)), kj, vj, jnp.int32(start), cfg, jnp.asarray(kv_min),
        **{k: jnp.asarray(v) for k, v in extra.items()})
    # the port's --kv8 step: the two-part attention on the widened int8 rows
    got = tfa.batched_cache_attention_plain(
        *map(torch.from_numpy, (q, kn, vn)), tq.kv_read(kt, start), tq.kv_read(vt, start), start,
        torch.from_numpy(kv_min), **{k: torch.from_numpy(v) for k, v in extra.items()})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the kernels' plain versions against the tools/ Pallas probes (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probes():
    """The tools/ probe modules.  Importing them points JAX's persistent
    compile cache into the checkout when the backend is the CPU; the setting
    is restored before anything compiles, so nothing is written there."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        from tools import probe_int8, profile_decode2, profile_decode3
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return profile_decode2, profile_decode3, probe_int8


V_PROBE, H_PROBE, BLOCK = 1000, 64, 128


def _head_case(seed, tie=False):
    """Weights [V, H] (V not a multiple of the block), the same table padded
    to a block multiple with junk rows larger than any real logit (which the
    probes must mask), int8 copies, and 6 hidden rows."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((V_PROBE, H_PROBE)) * 0.05).astype(np.float32)
    h = rng.standard_normal((6, H_PROBE)).astype(np.float32)
    if tie:
        # rows 130 and 900 (different blocks) equal and the largest for h[0];
        # row 140 equals row 130 inside its block
        w[130] = np.sign(h[0]) * 0.5
        w[900] = w[140] = w[130]
    pad = np.full((1024 - V_PROBE, H_PROBE), 0.0, np.float32)
    pad[:] = np.sign(h[0]) * 10.0
    return w, np.concatenate([w, pad]), h


@pytest.mark.parametrize("tie", [False, True])
def test_argmax_plain_matches_pallas_bf16(probes, tie):
    pd2, pd3, _ = probes
    w, wpad, h = _head_case(6, tie)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = tam.argmax_matvec(torch.from_numpy(h), wb).tolist()
    wpad_j = jnp.asarray(wpad, jnp.bfloat16)
    for r in range(6):
        a = int(pd2.pallas_argmax_matvec(jnp.asarray(h[r]), wpad_j, V_PROBE, BLOCK))
        b = int(pd3.mv_argmax(jnp.asarray(h[r]), wpad_j, V_PROBE, BLOCK))
        assert got[r] == a == b, (r, got[r], a, b)
    one = tam.argmax_matvec(torch.from_numpy(h[:1]), wb)
    assert one.dtype == torch.int32 and one.tolist() == got[:1]
    if tie:
        assert got[0] == 130


@pytest.mark.parametrize("tie", [False, True])
def test_argmax_plain_matches_pallas_q8(probes, tie):
    _, _, pq8 = probes
    w, wpad, h = _head_case(7, tie)
    qw = tq.quantize_weight(torch.from_numpy(w))
    got = tam.argmax_matvec(torch.from_numpy(h), qw.q, qw.s).tolist()
    qpad = jq.quantize_weight(jnp.asarray(wpad))
    np.testing.assert_array_equal(np.asarray(qpad.q)[:V_PROBE], qw.q.numpy())
    for r in range(6):
        want = int(pq8.mv_q8_argmax(jnp.asarray(h[r]), qpad.q, qpad.s, V_PROBE, BLOCK))
        assert got[r] == want, (r, got[r], want)
    if tie:
        assert got[0] == 130


def test_argmax_plain_f32_is_linear_argmax():
    w, _, h = _head_case(8)
    got = tam.argmax_matvec(torch.from_numpy(h), torch.from_numpy(w))
    assert got.tolist() == np.argmax(h @ w.T, axis=-1).tolist()


def test_read_all_plain_matches_pallas(probes):
    _, pd3, _ = probes
    rng = np.random.default_rng(9)
    x = rng.standard_normal((512, 64)).astype(np.float32)
    want = float(pd3.read_all(jnp.asarray(x, jnp.bfloat16), jnp.float32(0.25), 128))
    got = tprobes.read_all(torch.from_numpy(x).to(torch.bfloat16), 0.25)
    assert got.shape == () and float(got) == want


def test_probe_mm_plain_is_the_kernel_body():
    # tools/probe_compile_cache.py runs at import, so its body (x @ y of two
    # [256, 256] f32 blocks) is held against numpy instead
    rng = np.random.default_rng(10)
    x, y = (rng.standard_normal((256, 256)).astype(np.float32) for _ in range(2))
    got = tprobes.probe_mm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, x @ y, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# --q8 engine against the JAX Engine(q8=True), same JAX-quantized tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def q8_engines(tiny_model_dir):
    j = JEngine(tiny_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32, q8=True)
    t = Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
               device="cpu", q8=True)
    _, t.dec_params = tpm.params_from_jax(_as_np(j.enc_params), _as_np(j.dec_params), "cpu",
                                          torch.float32)
    assert isinstance(t.dec_params["layers"]["wqkv"], tq.QuantW)
    assert t.dec_params["lm_head"] is t.dec_params["embed"]
    return j, t


def test_q8_engine_logits_and_tokens_match_jax(q8_engines, speech_like_audio):
    """Prefill logits within 1e-4 of their largest magnitude (f32 sums in
    another order through two int8 layers) and the same greedy tokens."""
    j, t = q8_engines
    mel = log_mel(speech_like_audio)
    ja, n = j.encode_mel(mel)
    ta, _ = t.encode_mel(mel)
    ids, a0 = jprompt.build_asr_prompt(j.cfg, n, (), ())
    j.reset_kv()
    t.reset_kv()
    want, _ = j.prefill_ids(ids, ja, a0, n, greedy=False)
    got, _ = t.prefill_ids(ids, ta, a0, n, greedy=False)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    toks = []
    for eng, audio, pm in ((j, ja, jprompt), (t, ta, tprompt)):
        ids, a0 = pm.build_asr_prompt(eng.cfg, n, (), ())
        eng.reset_kv()
        first, pos = eng.prefill_ids(ids, audio, a0, n)
        out = []
        eng.decode_greedy(first, pos, 20, lambda tid: out.append(tid) or True)
        toks.append(out)
    assert len(toks[1]) > 1 and toks[1] == toks[0]


# ---------------------------------------------------------------------------
# --kv8 batched paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kv8_engines(tmp_path_factory):
    from tools.make_tiny_model import build

    d = build("tiny", str(tmp_path_factory.mktemp("kv8") / "model"), seed=5, dtype="f32",
              full_vocab=True)
    j = JEngine(d, param_dtype=jnp.float32, kv_dtype=jnp.float32, kv8=True)
    t = Engine(d, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu", kv8=True)
    for eng in (j, t):
        eng.max_tokens = 8
        eng.set_force_language("English")
    return j, t


def test_serving_under_kv8_matches_one_shot_and_jax(kv8_engines):
    """The scheduler and the one-shot batch run the same quantized math;
    slot reuse and mid-flight admission admit and grow the QuantKV cache."""
    j, t = kv8_engines
    clips = serving_clips(5)
    one_shot = tbs.transcribe_segments_batched(t, clips)
    served = tserving.serve_continuous(t, clips, slots=2)
    assert served == one_shot
    assert served == jserving.serve_continuous(j, clips, slots=2)
    assert one_shot == jbs.transcribe_segments_batched(j, clips)
    assert any(served)


# ---------------------------------------------------------------------------
# CLI stdout byte-equal to the JAX CLI
# ---------------------------------------------------------------------------

def _cli(module, args):
    env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                          timeout=600, env=env, cwd=REPO)


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, speech_like_audio):
    from tests.test_torch_engine import _wav_bytes
    from tools.make_tiny_model import build

    d = tmp_path_factory.mktemp("q8cli")
    model = build("tiny", str(d / "model"), seed=5, dtype="f32", full_vocab=True)
    wavs = []
    for i, clip in enumerate([speech_like_audio] + serving_clips(2, seed=31)):
        path = d / f"clip{i}.wav"
        path.write_bytes(_wav_bytes(clip))
        wavs.append(str(path))
    return model, wavs


@pytest.mark.parametrize("mode", ["q8", "kv8_segments", "kv8_serve"])
def test_cli_stdout_byte_equal(cli_inputs, mode):
    model, wavs = cli_inputs
    base = ["-d", model, "--language", "English", "--max-tokens", "8", "--silent"]
    extra = {"q8": ["-i", wavs[0], "--q8"],
             "kv8_segments": ["-i", wavs[0], "-S", "1", "-W", "0.4", "--kv8", "--f32"],
             "kv8_serve": ["-i", *wavs, "--serve", "2", "--kv8", "--f32"]}[mode]
    j = _cli("smolvision_tpu.cli", base + extra)
    t = _cli("smolvision_tpu_torch.cli", base + extra)
    assert j.returncode == 0, j.stderr.decode()
    assert t.returncode == 0, t.stderr.decode()
    assert len(t.stdout.strip()) > 0
    assert t.stdout == j.stdout
