"""The port's device-side decode loop (runtime/decode_graph.py) against the JAX
package's, on the CPU, where the loop's step runs eagerly.

On the card one decode step is a CUDA graph replayed per token: kernel B3
reads its position from device memory on a fixed grid of DECODE_MAX_BLOCKS
blocks per KV head, the cache row is written at the device position, and
the batched step attends the whole cache under a mask built from it.  Here
the same step runs through the kernels' plain versions, and:

  * B3's fixed-shape plain form (a position tensor, every cache row under a
    mask) equals the host-int form and the Pallas kernel in interpret mode
    within 1e-5 (f32 softmax-attention over <= 128 keys of outputs of
    magnitude <~ 3: they differ only in summation order, ~1e-6);
  * a numpy emulation of the fixed partition covers [kv_min, start) once,
    and an empty block's partial merges to nothing, exactly;
  * the device-position single and batched steps give the JAX package's
    greedy token ids on the tiny f32 checkpoint (exactly), at EOS and
    max_tokens edges, across a cache growth, and on bf16, f32 and int8
    (--kv8) batched caches;
  * a replay adds the launches its capture recorded (a stub graph).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.kernels import flash_attention as jfa
from smolvision_tpu.models import qwen3_decoder as jdec
from smolvision_tpu.runtime import engine as jengine_mod
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.kernels import ffi
from smolvision_tpu_torch.kernels import flash_attention as tfa
from smolvision_tpu_torch.models import qwen3_decoder as tdec
from smolvision_tpu_torch.parallel import batch as tbatch
from smolvision_tpu_torch.runtime import decode_graph
from smolvision_tpu_torch.runtime import engine as tengine_mod
from smolvision_tpu_torch.runtime.engine import Engine

TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = list(range(100, 160))   # 60 ids: a 512-row cache, grown to 1024 past row 511


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    return (JEngine(tiny_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32),
            Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                   device="cpu"))


# ---------------------------------------------------------------------------
# B3: the fixed-shape plain form and the fixed grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("start,kv_min", [(0, 0), (1, 0), (17, 0), (17, 5), (127, 0), (127, 9)])
def test_b3_device_position_plain_matches_host_form_and_pallas(G, cache, start, kv_min):
    K, KH, D = 128, 2, 64
    H = G * KH
    rng = np.random.default_rng(start * 31 + kv_min + G)
    q = rng.standard_normal((H, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((KH, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((K, KH, D)).astype(np.float32) for _ in range(2))
    k[start:], v[start:] = 999.0, -999.0  # never attended
    dt_t, dt_j = (torch.bfloat16, jnp.bfloat16) if cache == "bf16" else (torch.float32,
                                                                          jnp.float32)
    tq, tkn, tvn = map(torch.from_numpy, (q, kn, vn))
    tk, tv = torch.from_numpy(k).to(dt_t), torch.from_numpy(v).to(dt_t)
    host = tfa.decode_attention_plain(tq, tkn, tvn, tk, tv, start, kv_min).numpy()
    # the decode step's position: int64 [1]; kv_min as a tensor and as an int
    pos = torch.tensor([start])
    dev = tfa.decode_flash_attention(tq, tkn, tvn, tk, tv, pos, torch.tensor(kv_min)).numpy()
    dev_int_min = tfa.decode_attention_plain(tq, tkn, tvn, tk, tv, pos, kv_min).numpy()
    want = np.asarray(jfa.decode_flash_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k, dt_j),
        jnp.asarray(v, dt_j), jnp.int32(start), jnp.int32(kv_min), gqa_groups=G))
    np.testing.assert_allclose(dev, host, **TOL)
    np.testing.assert_allclose(dev_int_min, host, **TOL)
    np.testing.assert_allclose(dev, want, **TOL)


def fixed_grid(start: int, kv_min: int, blocks: int = tfa.DECODE_MAX_BLOCKS):
    """Each block's rows [lo, hi) as csrc/decode_attention.cu works them out
    from the device position: chunk = ceil(live / blocks)."""
    chunk = -(-max(start - kv_min, 0) // blocks)
    return [(kv_min + r * chunk, min(kv_min + (r + 1) * chunk, start)) for r in range(blocks)]


@pytest.mark.parametrize("start,kv_min", [(0, 0), (1, 0), (7, 0), (8, 0), (9, 0), (17, 5),
                                          (20, 30), (315, 0), (4095, 0), (4096, 4095)])
def test_fixed_grid_covers_the_live_rows_once(start, kv_min):
    seen = np.zeros(max(start, kv_min) + 1, np.int64)
    for lo, hi in fixed_grid(start, kv_min):
        if hi > lo:
            seen[lo:hi] += 1
    want = np.zeros_like(seen)
    want[min(kv_min, start):start] = 1
    np.testing.assert_array_equal(seen, want)


def _merge(parts):
    """(m, l, acc) partials brought to one max, as the cluster merges them
    (scores in log2 units: exp2)."""
    mx = max(m for m, _, _ in parts)
    f = [np.exp2(m - mx) for m, _, _ in parts]
    return (mx, sum(fi * li for fi, (_, li, _) in zip(f, parts)),
            sum(fi * a for fi, (_, _, a) in zip(f, parts)))


def test_empty_blocks_merge_to_nothing():
    """A block with no live row leaves (m, l, acc) = (-1e30, 0, 0); the merge
    weighs it by exp2(-1e30 - m) = 0, so the output is bit-equal without it,
    and with only empty blocks it is the fresh row's value."""
    rng = np.random.default_rng(3)
    empty = (np.float32(tfa.NEG_INF), np.float32(0.0), np.zeros(8, np.float32))
    fresh = (np.float32(1.5), np.float32(1.0), rng.standard_normal(8).astype(np.float32))
    live = [(np.float32(rng.standard_normal()), np.float32(2.0),
             rng.standard_normal(8).astype(np.float32)) for _ in range(3)]
    for parts in (live + [fresh], [fresh]):
        _, l0, a0 = _merge(parts)
        _, l1, a1 = _merge(parts + [empty] * (tfa.DECODE_MAX_BLOCKS - len(parts) + 1))
        assert l1 == l0 and np.array_equal(a1, a0)
    _, l, a = _merge([empty] * tfa.DECODE_MAX_BLOCKS + [fresh])
    np.testing.assert_array_equal(a / l, fresh[2])


# ---------------------------------------------------------------------------
# the single-stream step and chunked decode_greedy
# ---------------------------------------------------------------------------

def _sliced_b3(q, k_new, v_new, k_cache, v_cache, start_pos, kv_min=0):
    """B3's host-int form: the live rows only, the position read back."""
    return tfa.decode_attention_plain(q, k_new, v_new, k_cache, v_cache, int(start_pos), kv_min)


def test_device_step_matches_host_int_step_and_jax_chunks(engines, monkeypatch):
    """The chunked device loop (decode_greedy), a per-token loop through B3's
    host-int form, and the JAX engine's `_decode_chunk`, across the cache's
    growth from 512 to 1024 rows: the same token ids."""
    jeng, teng = engines
    steps = 470
    jeng.reset_kv()
    first, pos = jeng.prefill_ids(PROMPT, None, -1, 0)
    want = [int(first)]
    tok, p = jnp.asarray(first, jnp.int32), jnp.int32(pos)
    while len(want) < steps + 1:
        n = min(jengine_mod.DECODE_CHUNK, steps + 1 - len(want))
        kv = jeng._ensure_kv(pos + n + 1)
        buf, count, tok, p, jeng._kv = jeng._decode_chunk(jeng.dec_params, tok, p, kv,
                                                          jnp.int32(n))
        want += [int(t) for t in np.asarray(buf)[: int(count)]]
        pos += int(count)
        assert int(count) == n, "no EOS expected in this run"

    teng.reset_kv()
    first, pos = teng.prefill_ids(PROMPT, None, -1, 0)
    got = []
    teng.perf.reset()
    teng.decode_greedy(first, pos, steps + 1, lambda t: got.append(t) or True)
    assert teng._kv_cap == 1024
    assert teng.perf.decode_steps == steps and teng.perf.wasted_steps == 0

    teng.reset_kv()
    first, pos = teng.prefill_ids(PROMPT, None, -1, 0)
    host = [int(first)]
    with monkeypatch.context() as m:
        m.setattr(tfa, "decode_flash_attention", _sliced_b3)
        for i in range(steps):
            host.append(int(teng.decode_step(host[-1], pos + i)))
    assert got == host == want


def _greedy(eng, max_tokens, prompt=PROMPT):
    eng.reset_kv()
    first, pos = eng.prefill_ids(prompt, None, -1, 0)
    seen = []
    n = eng.decode_greedy(first, pos, max_tokens, lambda t: seen.append(t) or True)
    return n, seen


@pytest.fixture(scope="module")
def sequence(engines):
    """The first 130 greedy tokens after PROMPT (no EOS among them)."""
    n, seen = _greedy(engines[1], 130)
    assert n == 130 and len(seen) == 130
    return seen


@pytest.mark.parametrize("max_tokens", [1, 2, 64, 65])
def test_chunked_decode_greedy_budget_edges(engines, sequence, max_tokens):
    jeng, teng = engines
    want = _greedy(jeng, max_tokens)
    assert _greedy(teng, max_tokens) == want == (max_tokens, sequence[:max_tokens])


# prompts whose greedy sequence on the tiny checkpoint shows a token for the
# first time at index 64 (the first chunk's last step) or 65 (the next
# chunk's first step); the random net repeats itself, so few prompts do
@pytest.mark.parametrize("eos_at,prompt", [(0, PROMPT), (64, list(range(73755, 73767))),
                                           (65, list(range(79912, 79923)))])
def test_chunked_decode_greedy_stops_at_eos(tiny_model_dir, engines, monkeypatch, eos_at,
                                            prompt):
    """EOS as the prefill token (0), on the first chunk's last step (64: the
    64th decoded token) and on the next chunk's first (65): both engines
    stop there, the callback never sees the EOS, and n counts it."""
    _, sequence = _greedy(engines[1], eos_at + 1, prompt)
    token = sequence[eos_at]
    assert sequence.index(token) == eos_at
    for mod in (jengine_mod, tengine_mod, decode_graph):
        monkeypatch.setattr(mod, "EOS_TOKEN_IDS", (token,))
    jeng = JEngine(tiny_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32)
    teng = engines[1]
    teng.perf.reset()
    want = _greedy(jeng, 200, prompt)
    got = _greedy(teng, 200, prompt)
    assert got == want == (eos_at + 1, sequence[:eos_at])
    # on the CPU the loop reads the flags after every step: none past the EOS
    assert teng.perf.decode_steps == eos_at and teng.perf.wasted_steps == 0


# ---------------------------------------------------------------------------
# the batched step
# ---------------------------------------------------------------------------

def _embeds(cfg, B, T, seed):
    return (np.random.default_rng(seed).standard_normal((B, T, cfg.dec_hidden)) * 0.5
            ).astype(np.float32)


CACHES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "kv8": (torch.int8, jnp.int8)}


@pytest.mark.parametrize("cache", ["f32", "bf16", "kv8"])
@pytest.mark.parametrize("natural", [False, True])
def test_batched_masked_step_matches_sliced_form(engines, cache, natural):
    """One batched decoder step at a device position (the whole cache under
    a mask) against the same step at a host position (B5's plain version
    over the sliced live rows): hidden states within 1e-5 of their largest
    magnitude (f32 sums over the same terms plus masked zeros), and equal
    cache writes."""
    _, teng = engines
    cfg = teng.cfg
    B, T, K = 3, 64, 96
    pads = torch.tensor([0, 12, 40], dtype=torch.int32)
    emb = torch.from_numpy(_embeds(cfg, B, T, 7))
    step = torch.from_numpy(_embeds(cfg, B, 1, 8))
    extra = {}
    if natural:
        extra = dict(prompt_max=torch.tensor([50, 64, 30], dtype=torch.int32),
                     region_start=torch.tensor([64, 64, 64], dtype=torch.int32))
    outs = []
    for pos in (T, torch.tensor([T])):
        kv = tdec.make_batched_kv(cfg, B, K, CACHES[cache][0], "cpu")
        _, kv = tdec.batched_prefill(teng.dec_params, cfg, emb, kv, -pads, pads, greedy=False)
        hidden, kv = tdec.batched_decoder_forward(teng.dec_params, cfg, step, pos, kv,
                                                  T - pads, pads, **extra)
        outs.append((hidden, kv))
    (h_host, kv_host), (h_dev, kv_dev) = outs
    assert float((h_dev - h_host).abs().max()) <= 1e-5 * float(h_host.abs().max())
    leaves = (lambda kv: kv) if cache == "kv8" else (lambda kv: [kv])
    for a, b in zip(leaves(kv_dev), leaves(kv_host)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cache", ["f32", "bf16", "kv8"])
@pytest.mark.parametrize("active", [(True, True, True), (True, False, True)])
def test_batched_decode_chunk_matches_jax_on_each_cache(engines, cache, active):
    """A decode chunk on the device loop after a left-padded prefill:
    buffer, count and last tokens equal the JAX package's
    `batched_decode_chunk`, with and without an inactive row."""
    jeng, teng = engines
    cfg = teng.cfg
    B, T, K, cap = 3, 64, 128, 8
    emb = _embeds(cfg, B, T, 11)
    pads = np.asarray([0, 12, 40], np.int32)
    act = np.asarray(active)
    t_dt, j_dt = CACHES[cache]
    jtok, jkv = jdec.batched_prefill(jeng.dec_params, jeng.cfg, jnp.asarray(emb),
                                     jdec.make_batched_kv(jeng.cfg, B, K, j_dt),
                                     jnp.asarray(-pads), jnp.asarray(pads))
    jbuf, jn, jlast, _ = jdec.batched_decode_chunk(
        jeng.dec_params, jeng.cfg, jtok, jnp.int32(T), jkv, cap, jnp.asarray(pads),
        jnp.asarray(pads), n_steps=jnp.int32(6), row_active=jnp.asarray(act))
    ttok, tkv = tdec.batched_prefill(teng.dec_params, cfg, torch.from_numpy(emb),
                                     tdec.make_batched_kv(cfg, B, K, t_dt, "cpu"),
                                     torch.from_numpy(-pads), torch.from_numpy(pads))
    tbuf, tn, tlast, _ = tbatch.batched_decode_chunk(
        teng.dec_params, cfg, ttok, T, tkv, cap, rope_offset=torch.from_numpy(pads),
        kv_min=torch.from_numpy(pads), n_steps=6, row_active=torch.from_numpy(act))
    assert tn == int(jn)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


def test_batched_loop_keeps_its_state_across_chunks(engines):
    """Two chunks of one loop (the graph the callers keep) equal one chunk
    twice as long on a fresh loop, and a chunk whose rows are all done runs
    no step."""
    _, teng = engines
    cfg = teng.cfg
    B, T, K = 2, 64, 128
    pads = torch.tensor([0, 9], dtype=torch.int32)
    emb = torch.from_numpy(_embeds(cfg, B, T, 13))
    runs = []
    for split in ((10,), (4, 6)):
        kv = tdec.make_batched_kv(cfg, B, K, torch.float32, "cpu")
        tok, kv = tdec.batched_prefill(teng.dec_params, cfg, emb, kv, -pads, pads)
        loop = tbatch.batched_decode_loop(teng.dec_params, cfg, kv, B)
        pos, rows = T, []
        for steps in split:
            buf, count, replays = loop.run(tok, pos, steps, rope_offset=pads, kv_min=pads)
            assert count == replays == steps
            rows.append(buf)
            tok, pos = loop.tok, pos + count
        runs.append(np.concatenate(rows, axis=1))
        buf, count, replays = loop.run(tok, pos, 4, row_active=np.zeros(B, bool),
                                       rope_offset=pads, kv_min=pads)
        assert (count, replays) == (0, 0)
    np.testing.assert_array_equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------

def test_replay_adds_the_launches_its_capture_recorded(monkeypatch):
    """A stub graph: capturing runs the step's Python once (the wrappers
    count, the card launches nothing), a replay runs no Python.  After the
    capture the counts are as before it; each replay adds the step's
    launches."""
    def step():
        ffi.launch_counts["decode_attention"] += 28
        ffi.launch_counts["argmax_matvec"] += 1

    replays = []

    def stub_capture(fn, stream):
        fn()
        return lambda: replays.append(stream)

    monkeypatch.setattr(decode_graph, "capture", stub_capture)
    before = dict(ffi.launch_counts)
    graph = decode_graph.StepGraph(step, "stream")
    assert ffi.launch_counts == before
    assert graph.launches == {"decode_attention": 28, "argmax_matvec": 1}
    for _ in range(5):
        graph.replay()
    assert len(replays) == 5
    delta = {k: ffi.launch_counts[k] - n for k, n in before.items() if ffi.launch_counts[k] != n}
    assert delta == {"decode_attention": 140, "argmax_matvec": 5}


def test_loop_counts_each_step_once():
    """Through a DecodeLoop on the CPU (the eager step is its own replay):
    the eager first step and every later step count their launches once."""
    def forward(tok, pos):
        ffi.launch_counts["decode_attention"] += 3
        return (tok + 1).to(torch.int32)

    loop = decode_graph.DecodeLoop(forward, 2, None, 16, "cpu", None)
    before = ffi.launch_counts["decode_attention"]
    buf, count, replays = loop.run(torch.tensor([5, 9]), 0, 7)
    assert (count, replays) == (7, 7)
    assert ffi.launch_counts["decode_attention"] - before == 21
    np.testing.assert_array_equal(buf, [[6, 7, 8, 9, 10, 11, 12], [10, 11, 12, 13, 14, 15, 16]])
    assert loop.graph.launches == {}
    with pytest.raises(ValueError, match="past its 16"):
        loop.run(torch.tensor([5, 9]), 10, 7)   # rows 10..17 of a 16-row cache
