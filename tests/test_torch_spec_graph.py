"""--spec's device chunk, the prefill graphs and kernel B2 at a device start,
against the JAX package on the CPU.

On the card a --spec iteration (SPEC_DRAFT int8 decode steps, one verify
forward through B2 at a device start, the greedy head over its rows and the
accept step) is one CUDA graph replayed per iteration
(runtime/decode_graph.SpecLoop, the JAX engine's `_get_spec_chunk`), and a
greedy prefill is one graph per (cache, block rows), captured on its second
call (PrefillGraph, the JAX engine's `_prefill_greedy`).  Here the same
steps run eagerly through the kernels' plain versions, and:

  * B2's fixed-shape plain form (a start tensor, every cache row under a
    mask) equals the host-int form and the Pallas kernel in interpret mode
    within 1e-5 (f32 sums over the same terms plus masked zeros);
  * `decoder_forward` at a device start equals the host-int call and the
    JAX `prefill`: logits and cache rows within 1e-5;
  * per chunk, SpecLoop's tokens, count, iterations and end position equal
    the JAX `_get_spec_chunk`'s, and its tokens plain greedy's, exactly, on
    a tiny f32 checkpoint with an untied head (varied tokens, partial
    accepts), also where an EOS falls on an iteration's first, a middle or
    its extra token, and across a cache growth between chunks;
  * the accept step against a numpy transcription of the reference's on
    scripted drafts and verifies;
  * --spec under --stream equals the plain stream, in both packages, and
    toggling engine.spec reproduces plain greedy;
  * a prefill graph runs its first call eagerly, captures its second and
    replays after, keyed on (cache, block rows) and dropped with the cache,
    and its launches count once per call.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.kernels import flash_attention as jfa
from smolvision_tpu.models import qwen3_decoder as jdec
from smolvision_tpu.runtime import engine as jengine_mod
from smolvision_tpu.runtime import stream as jstream
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.kernels import ffi
from smolvision_tpu_torch.kernels import flash_attention as tfa
from smolvision_tpu_torch.models import qwen3_decoder as tdec
from smolvision_tpu_torch.runtime import decode_graph
from smolvision_tpu_torch.runtime import engine as tengine_mod
from smolvision_tpu_torch.runtime import stream as tstream
from smolvision_tpu_torch.runtime.engine import Engine
from tests.test_torch_stream import build_stream_model

TOL = dict(rtol=1e-5, atol=1e-5)
# 150 ids: a 192-row prefill block; its greedy run on the untied checkpoint
# shows each of its first 50 tokens for the first time and holds partial
# accepts in its first chunk
PROMPT = list(range(2000, 2150))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return build_stream_model(str(tmp_path_factory.mktemp("models") / "tiny-untied"))


@pytest.fixture(scope="module")
def engines(model_dir):
    """(JAX --spec, port --spec, port plain, JAX plain), f32 weights and cache."""
    return (JEngine(model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32, spec=True),
            Engine(model_dir, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu",
                   spec=True),
            Engine(model_dir, param_dtype=torch.float32, kv_dtype=torch.float32, device="cpu"),
            JEngine(model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32))


def _greedy(eng, max_tokens, prompt=PROMPT):
    eng.reset_kv()
    first, pos = eng.prefill_ids(prompt, None, -1, 0)
    seen = []
    n = eng.decode_greedy(first, pos, max_tokens, lambda t: seen.append(t) or True)
    return n, seen


def _port_chunks(teng, max_tokens, monkeypatch):
    """The port's decode_greedy with each SpecLoop chunk recorded: (tokens,
    count, iterations, end position, cache rows)."""
    chunks = []
    run = decode_graph.SpecLoop.run

    def spy(self, *args):
        out = run(self, *args)
        chunks.append((out[0][0].tolist(), out[1], self.iterations, int(self.pos),
                       self.capacity))
        return out

    with monkeypatch.context() as m:
        m.setattr(decode_graph.SpecLoop, "run", spy)
        got = _greedy(teng, max_tokens)
    return got, chunks


def _jax_chunks(jeng, max_tokens):
    """The JAX engine's decode_greedy with each `_get_spec_chunk` call
    recorded: (tokens, count, iterations, end position)."""
    chunks = []
    jeng._spec_chunk_jit = None
    real = jeng._get_spec_chunk()

    def spy(*args):
        out = real(*args)
        buf, count, _, pos, _, it = out
        chunks.append((np.asarray(buf)[: int(count)].tolist(), int(count), int(it), int(pos)))
        return out

    jeng._spec_chunk_jit = spy
    try:
        got = _greedy(jeng, max_tokens)
    finally:
        jeng._spec_chunk_jit = None
    return got, chunks


# ---------------------------------------------------------------------------
# B2 at a device start, and the decoder over it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("T,start,valid", [(5, 0, 5), (5, 123, 128), (5, 200, 203),
                                           (64, 0, 41), (64, 96, 160), (128, 40, 150),
                                           (128, 128, 256)])
def test_b2_device_start_plain_matches_host_form_and_pallas(cache, T, start, valid):
    K, H, KH, D = 256, 4, 2, 64
    rng = np.random.default_rng(T * 7 + start)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((K, KH, D)).astype(np.float32) for _ in range(2))
    k[valid:], v[valid:] = 999.0, -999.0   # pad and stale rows: never attended
    dt_t, dt_j = (torch.bfloat16, jnp.bfloat16) if cache == "bf16" else (torch.float32,
                                                                          jnp.float32)
    tq = torch.from_numpy(q)
    tk, tv = torch.from_numpy(k).to(dt_t), torch.from_numpy(v).to(dt_t)
    host = tfa.causal_cache_attention_plain(tq, tk, tv, start, valid).numpy()
    at = torch.tensor([start])
    dev = tfa.causal_cache_flash_attention(tq, tk, tv, at, at + (valid - start)).numpy()
    dev_int_valid = tfa.causal_cache_attention_plain(tq, tk, tv, at, valid).numpy()
    want = np.asarray(jfa.causal_cache_flash_attention(
        jnp.asarray(q), jnp.asarray(k, dt_j), jnp.asarray(v, dt_j), jnp.int32(start),
        jnp.int32(valid), gqa_groups=H // KH))
    np.testing.assert_allclose(dev, host, **TOL)
    np.testing.assert_allclose(dev_int_valid, host, **TOL)
    np.testing.assert_allclose(dev, want, **TOL)


def test_b2_device_start_honours_kv_min():
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((64, 4, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((256, 2, 64)).astype(np.float32))
            for _ in range(2))
    host = tfa.causal_cache_attention_plain(q, k, v, 96, 150, 40)
    dev = tfa.causal_cache_attention_plain(q, k, v, torch.tensor([96]), torch.tensor([150]), 40)
    torch.testing.assert_close(dev, host, **TOL)


@pytest.mark.parametrize("start,valid", [(0, 50), (37, 64)])
def test_decoder_forward_at_device_start_matches_host_int_and_jax(engines, start, valid):
    """A 64-row block written at a device start (RoPE, cache rows by
    index_copy_, B2's kv_valid on the device) against the host-int call
    and the JAX `prefill`: logits of the last valid row and every cache row
    within 1e-5; the device form's greedy token (index_select of the last
    valid row) equals the host form's."""
    jeng, _, teng, _ = engines
    cfg = teng.cfg
    T, K = 64, 256
    rng = np.random.default_rng(start + 5)
    emb = (rng.standard_normal((T, cfg.dec_hidden)) * 0.5).astype(np.float32)
    ctx = (rng.standard_normal((T, cfg.dec_hidden)) * 0.5).astype(np.float32)
    caches, logits, toks = [], [], []
    for at in (start, torch.tensor([start])):
        kv = tdec.make_kv_cache(cfg, K, torch.float32, "cpu")
        if start:  # rows below start hold a context of their own
            tdec.decoder_forward(teng.dec_params, cfg, torch.from_numpy(ctx), 0, start, kv)
        hidden, kv = tdec.decoder_forward(teng.dec_params, cfg, torch.from_numpy(emb), at,
                                          valid if isinstance(at, int) else torch.tensor([valid]),
                                          kv)
        logits.append(tdec.logits_at(teng.dec_params, cfg, hidden, valid - 1).numpy())
        caches.append(kv.clone())
        n = valid if isinstance(at, int) else torch.tensor([valid])
        toks.append(int(tdec.greedy_head(teng.dec_params, cfg, tdec.last_row(hidden, n))[0]))
    jkv = jdec.make_kv_cache(jeng.cfg, K, jnp.float32)
    if start:
        _, jkv = jdec.prefill(jeng.dec_params, jeng.cfg, jnp.asarray(ctx), jnp.int32(0),
                              jnp.int32(start), jkv, greedy=False)
    jlogits, jkv = jdec.prefill(jeng.dec_params, jeng.cfg, jnp.asarray(emb), jnp.int32(start),
                                jnp.int32(valid), jkv, greedy=False)
    np.testing.assert_allclose(logits[1], logits[0], **TOL)
    np.testing.assert_allclose(logits[1], np.asarray(jlogits), **TOL)
    torch.testing.assert_close(caches[1], caches[0], **TOL)
    np.testing.assert_allclose(caches[1][:, :, : start + valid].numpy(),
                               np.asarray(jkv)[:, :, : start + valid], **TOL)
    assert toks[0] == toks[1]


# ---------------------------------------------------------------------------
# the accept step
# ---------------------------------------------------------------------------

def _reference_accept(d, g, n_steps, out, eos):
    """The reference's accept (smolvision_tpu/runtime/engine.py
    _get_spec_chunk, :550-562), in numpy: (e, done)."""
    n = len(d)
    a = int(np.sum(np.cumprod((np.asarray(d) == np.asarray(g[:n])).astype(np.int32))))
    idx = np.arange(n + 1)
    is_eos = np.isin(g, list(eos))
    eos_pos = int(np.min(np.where(is_eos & (idx <= a), idx, n + 1)))
    e = max(min(a + 1, eos_pos + 1, n_steps - out), 1)
    return e, eos_pos + 1 <= e


@pytest.mark.parametrize("seed", range(6))
def test_spec_loop_accepts_as_the_reference(monkeypatch, seed):
    """SpecLoop over scripted forwards: each iteration the draft proposes
    `n` tokens and the verify answers with g, agreeing on a random prefix;
    an EOS (token 7) appears at random.  The chunk's buffer, count,
    iterations and end position follow the reference's accept rule applied
    on the host, iteration by iteration."""
    monkeypatch.setattr(decode_graph, "EOS_TOKEN_IDS", (7,))
    rng = np.random.default_rng(seed)
    n, steps, pos0 = 4, 23 + seed, 10
    script = []
    for _ in range(steps):
        d = rng.integers(10, 14, n)
        g = np.where(rng.random(n + 1) < 0.7, np.append(d, rng.integers(10, 14)),
                     rng.integers(10, 14, n + 1))
        g[rng.random(n + 1) < 0.04] = 7
        script.append((d.astype(np.int32), g.astype(np.int32)))
    state = {"it": 0}

    def draft(tok, at):
        j = int(at) - state["base"]
        return torch.tensor([script[state["it"]][0][j]], dtype=torch.int32)

    def verify(seq, at):
        state["base"] = None
        g = torch.from_numpy(script[state["it"]][1])
        state["it"] += 1
        return g

    class Loop(decode_graph.SpecLoop):
        def _step(self):
            state["base"] = int(self.pos)
            super()._step()

    loop = Loop(draft, verify, n, None, 1024, "cpu", None)
    buf, count, replays = loop.run(5, pos0, steps)
    want, out, done, it = [], 0, False, 0
    while not done and out < steps:
        d, g = script[it]
        e, done = _reference_accept(d, g, steps, out, (7,))
        want += g[:e].tolist()
        out += e
        it += 1
    assert buf[0].tolist() == want and count == out == len(want)
    assert loop.iterations == it == replays and int(loop.pos) == pos0 + out


# ---------------------------------------------------------------------------
# --spec's chunks against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_tokens", [1, 5, 23, 48, 65, 130])
def test_spec_chunks_match_jax(engines, monkeypatch, max_tokens):
    """Per chunk, SpecLoop's tokens (buf[:count]), count, iterations and end
    position equal the JAX `_get_spec_chunk`'s; the tokens equal plain
    greedy's.  65 and 130 tokens cross a chunk (64 tokens a chunk)."""
    jspec, tspec, tplain, _ = engines
    tspec.perf.reset()
    got, chunks = _port_chunks(tspec, max_tokens, monkeypatch)
    jgot, jchunks = _jax_chunks(jspec, max_tokens)
    assert got == jgot == _greedy(tplain, max_tokens)
    assert [c[:4] for c in chunks] == jchunks
    assert len(chunks) == (0 if max_tokens == 1 else -(-(max_tokens - 1) // 64))
    p = tspec.perf
    assert p.spec_iters == sum(c[2] for c in chunks)
    assert p.decode_steps == tengine_mod.SPEC_DRAFT * p.spec_iters
    assert p.spec_tokens == got[0] - 1 and p.wasted_steps == 0
    if max_tokens >= 48:   # the draft and the verify part somewhere: partial accepts
        assert p.spec_tokens < (tengine_mod.SPEC_DRAFT + 1) * p.spec_iters


@pytest.mark.parametrize("where", ["first", "middle", "extra"])
def test_spec_stops_at_eos_inside_an_iteration(engines, monkeypatch, where):
    """An EOS on an iteration's first token, on a middle token, and on its
    extra token (the verify's own choice after a partial accept): both
    engines stop there, the callback never sees the EOS, n counts it, and
    the chunk's count, iterations and end position are the JAX engine's."""
    jspec, tspec, _, _ = engines
    ends = []
    step = decode_graph.SpecLoop._step

    def spy(self):
        step(self)
        ends.append(int(self.out))

    with monkeypatch.context() as m:
        m.setattr(decode_graph.SpecLoop, "_step", spy)
        _, seen = _greedy(tspec, 65)
    first_chunk = [0] + ends[: ends.index(64) + 1]
    its = list(zip(first_chunk, first_chunk[1:]))
    n1 = tengine_mod.SPEC_DRAFT + 1
    part = next((lo, hi) for lo, hi in its if 2 <= hi - lo < n1)      # a partial accept
    full = next((lo, hi) for lo, hi in its if hi - lo == n1)
    at = {"first": part[0], "middle": full[0] + 2, "extra": part[1] - 1}[where] + 1
    token = seen[at]
    assert seen.index(token) == at, "the EOS must show for the first time there"
    for mod in (jengine_mod, tengine_mod, decode_graph):
        monkeypatch.setattr(mod, "EOS_TOKEN_IDS", (token,))
    got, chunks = _port_chunks(tspec, 200, monkeypatch)
    jgot, jchunks = _jax_chunks(jspec, 200)
    assert got == jgot == (at + 1, seen[:at])
    assert [c[:4] for c in chunks] == jchunks
    assert chunks[-1][1] == at and chunks[-1][0][-1] == token


def test_spec_cache_growth_between_chunks(engines, monkeypatch):
    """No headroom past the prefill block: the 150-id prompt's cache starts
    at 256 rows and grows to 512 before the second chunk, which drops the
    first cache's SpecLoop for a new one; tokens and chunks stay the JAX
    engine's."""
    jspec, tspec, _, _ = engines
    monkeypatch.setattr(tengine_mod, "KV_HEADROOM", 0)
    got, chunks = _port_chunks(tspec, 130, monkeypatch)
    jgot, jchunks = _jax_chunks(jspec, 130)
    assert [c[4] for c in chunks] == [256, 512, 512]
    assert got == jgot and [c[:4] for c in chunks] == jchunks
    assert tspec._loop.kv is tspec._kv and tspec._kv_cap == 512


def test_spec_toggle_matches_plain(engines):
    """engine.spec off on a --spec engine gives plain greedy (a DecodeLoop
    on the same cache), and back on the same tokens through a SpecLoop."""
    _, tspec, tplain, _ = engines
    ref = _greedy(tplain, 48)
    tspec.spec = False
    try:
        assert _greedy(tspec, 48) == ref
        assert isinstance(tspec._loop, decode_graph.DecodeLoop)
    finally:
        tspec.spec = True
    assert _greedy(tspec, 48) == ref
    assert isinstance(tspec._loop, decode_graph.SpecLoop)


def test_spec_streaming_matches_plain_in_both_packages(engines):
    """--spec under --stream (the counterpart of tests/test_spec.py's): the
    per-chunk decodes run through SpecLoop while the stream rolls back,
    reuses KV by prefix and prefills deltas over the rows the last verify
    block left past the accepted position; the text and committed pieces
    equal the plain stream's, in each package and across them."""
    jspec, tspec, tplain, jplain = engines
    rng = np.random.default_rng(21)
    t = np.arange(6 * 16000) / 16000
    clip = (0.3 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t))
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    outs = {}
    for tag, eng, mod in (("jax plain", jplain, jstream), ("jax spec", jspec, jstream),
                          ("port plain", tplain, tstream), ("port spec", tspec, tstream)):
        max_new = eng.stream_max_new_tokens
        eng.past_text_conditioning = True
        eng.stream_max_new_tokens = 12
        pieces = []
        eng.token_cb = pieces.append
        try:
            text = mod.transcribe_stream(eng, clip)
        finally:
            eng.token_cb = None
            eng.past_text_conditioning = False
            eng.stream_max_new_tokens = max_new
        outs[tag] = (text, b"".join(pieces))
    assert outs["port spec"][1], "the stream committed nothing"
    assert outs["port spec"] == outs["port plain"] == outs["jax spec"] == outs["jax plain"]
    assert tspec.perf.spec_iters > 0 and tspec.perf.reuse_prefills > 0


# ---------------------------------------------------------------------------
# prefill graphs
# ---------------------------------------------------------------------------

def test_prefill_graph_first_call_eager_then_captured_then_replayed(engines, monkeypatch):
    """A stub capture (its step's Python runs once, the launches it counts
    are taken back; a replay computes the step and counts nothing, as a
    CUDA graph's): a (cache, block rows) key's
    first prefill runs eagerly, its second is captured and replayed, the
    third replays.  Each call's token equals the eager prefill's at host
    ints, and each counts one prefill's launches once.  A new cache (reset,
    growth) starts its keys over."""
    _, _, teng, _ = engines
    captured = []

    def stub_capture(fn, stream):
        fn()
        captured.append(fn)

        def replay():   # computes as the graph would, with no wrapper's count
            kept = dict(ffi.launch_counts)
            fn()
            ffi.launch_counts.update(kept)

        return replay

    def counting_b2(*args, **kwargs):   # the plain version counts no launch: count here
        ffi.launch_counts["causal_cache_attention"] += 1
        return b2(*args, **kwargs)

    b2 = tfa.causal_cache_flash_attention
    monkeypatch.setattr(decode_graph, "capture", stub_capture)
    monkeypatch.setattr(tfa, "causal_cache_flash_attention", counting_b2)
    cfg, L = teng.cfg, teng.cfg.dec_layers
    teng.reset_kv()
    teng.perf.reset()
    plain_kv = tdec.make_kv_cache(cfg, 512, torch.float32, "cpu")
    for i, (ids, start) in enumerate(((list(range(300, 340)), 0), (list(range(500, 530)), 40),
                                      (list(range(700, 750)), 70))):
        embeds = teng._embeds(ids, 64, None, 0, 0)
        before = ffi.launch_counts["causal_cache_attention"]
        tok = teng._prefill(embeds, start, len(ids), greedy=True)
        assert ffi.launch_counts["causal_cache_attention"] - before == L
        want, plain_kv = tdec.prefill(teng.dec_params, cfg, embeds, start, len(ids), plain_kv)
        assert int(tok) == int(want)
        assert len(captured) == (0 if i == 0 else 1)
    # the graph's prefills wrote the rows the host-int prefills did
    torch.testing.assert_close(teng._kv[:, :, :134], plain_kv[:, :, :134], **TOL)
    graph = teng._prefills[64]
    assert graph.calls == 3 and graph.graph.kind == "prefill"
    assert teng.perf.prefill_replays == 2 and teng.perf.prefills == 3
    assert teng.perf.reuse_prefills == 2
    teng.reset_kv()
    assert teng._prefills == {}


def test_prefill_graphs_keyed_per_cache_and_rows(engines):
    """Block rows of 64 and 128 on one cache are two graphs; a growth drops
    them with the cache; the logits path stays eager (no graph)."""
    _, _, teng, _ = engines
    teng.reset_kv()
    teng.prefill_ids(list(range(100, 130)), None, -1, 0)
    teng.prefill_with_reuse(list(range(100, 230)), None, -1, 0, reused=30)
    assert sorted(teng._prefills) == [64, 128]
    kv = teng._kv
    teng.prefill_ids(list(range(100, 130)), None, -1, 0, greedy=False)
    assert sorted(teng._prefills) == [64, 128]
    teng._ensure_kv(4 * teng._kv_cap)
    assert teng._kv is not kv and teng._prefills == {}
