"""The port's hand-written CUDA kernels against their plain versions, on the card.

Imports neither jax nor smolvision_tpu, so it runs on a card host without
the JAX package's test dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Skips (inside the test, never at collection) where there is no card.
Both sides compute in f32 from the same inputs and differ only in summation
order: 1e-4 absolute at outputs of magnitude <~ 3, as chip_smoke.py.
"""

import os

import numpy as np
import pytest
import torch

from smolvision_tpu_torch.kernels import argmax_matvec as tam
from smolvision_tpu_torch.kernels import ffi
from smolvision_tpu_torch.kernels import flash_attention as tfa
from smolvision_tpu_torch.kernels import probes as tprobes

ATOL = 1e-4


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)

    before = dict(ffi.launch_counts)
    calls = {name: 0 for name in before}

    # B1: windows shorter and longer than one block's 128 rows; a whole pad
    # window gives exactly 0; +-999 junk in pad keys must not leak in
    for S, lens in ((104, [104, 104, 52, 0]), (13, [13, 0]), (208, [208, 130])):
        q, k, v = (randn(len(lens), S, 14, 64) for _ in range(3))
        for w, n in enumerate(lens):
            k[w, n:], v[w, n:] = 999.0, -999.0
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = tfa.window_flash_attention(q, k, v, lens_t)
        close(got, tfa.window_attention_plain(q, k, v, lens_t))
        for w, n in enumerate(lens):
            assert n or not got[w].any()
        calls["window_attention"] += 1

    # B2 / B3: both head dims, bf16 and f32 caches, G = 1, 2 and 4, +-999 junk
    # in every row the call must not read
    for D, H, KH in ((128, 16, 8), (64, 16, 4), (128, 8, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            qc = randn(300, H, D)
            kc, vc = randn(1024, KH, D, dtype=dtype), randn(1024, KH, D, dtype=dtype)
            kc[330:], vc[330:] = 999.0, -999.0   # block rows 50..349, 330 valid
            close(tfa.causal_cache_flash_attention(qc, kc, vc, 50, 330, kv_min=7),
                  tfa.causal_cache_attention_plain(qc, kc, vc, 50, 330, 7))
            calls["causal_cache_attention"] += 1
            qd, kn, vn = randn(H, D), randn(KH, D), randn(KH, D)
            for start in (0, 1, 300, 1023):
                kd, vd = randn(1024, KH, D, dtype=dtype), randn(1024, KH, D, dtype=dtype)
                kd[start:], vd[start:] = 999.0, -999.0
                close(tfa.decode_flash_attention(qd, kn, vn, kd, vd, start, min(start, 5)),
                      tfa.decode_attention_plain(qd, kn, vn, kd, vd, start, min(start, 5)))
                calls["decode_attention"] += 1
    torch.cuda.synchronize()
    assert {k: ffi.launch_counts[k] - before[k] for k in before} == calls


@pytest.mark.cuda
def test_cuda_batched_kernels_match_plain_versions():
    """B4 and B5 at G 1 / 2 / 8 and at G 7 (Qwen2.5-Omni's decoder heads)
    and 3, which do not divide the 64-row block, D 64 / 128, T not a
    multiple of the block's queries per head, all-pad rows, kv_min > 0, B5
    at start 0 and > 0 with per-row and scalar region_start, bf16 and f32
    caches holding +-999 outside every window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)

    before = dict(ffi.launch_counts)
    calls = {name: 0 for name in before}
    for D, H, KH in ((128, 16, 8), (64, 8, 8), (64, 16, 2), (128, 28, 4), (64, 12, 4)):
        for T, kv_min in ((320, [0, 37, 320]), (100, [0, 5, 99])):
            q, k, v = randn(3, T, H, D), randn(3, T, KH, D), randn(3, T, KH, D)
            got = tfa.batched_causal_flash_attention(q, k, v, ints(kv_min))
            close(got, tfa.batched_causal_attention_plain(q, k, v, ints(kv_min)))
            for b, lo in enumerate(kv_min):
                assert not got[b, :lo].any()
            calls["batched_causal_attention"] += 1
        for dtype in (torch.bfloat16, torch.float32):
            K, T = 512, 64
            q, kn, vn = randn(3, T, H, D), randn(3, T, KH, D), randn(3, T, KH, D)
            for start, kv_min, pm, rs in (
                    (0, [0, 0, 0], [64, 40, 1], 1 << 30),
                    (200, [0, 9, 250], None, None),
                    (200, [0, 9, 30], [120, 64, 200], [150, 200, 100]),
                    (448, [3, 0, 0], [100, 7, 300], 320)):
                kv = randn(2, 2, 3, KH, K, D, dtype=dtype)
                kc, vc = kv[1, 0], kv[1, 1]         # strided views of the batched cache
                dead = torch.ones(3, K, dtype=torch.bool, device="cuda")
                for b in range(3):
                    lo = kv_min[b]
                    dead[b, lo:start] = False
                    if pm is not None:
                        r = rs if isinstance(rs, int) else rs[b]
                        c = torch.arange(lo, start, device="cuda") if start > lo else None
                        if c is not None:
                            dead[b, lo:start] = ~((c < pm[b]) | (c >= r))
                kc[dead[:, None, :].expand(3, KH, K)] = 999.0
                vc[dead[:, None, :].expand(3, KH, K)] = -999.0
                pm_t = None if pm is None else ints(pm)
                rs_t = rs if rs is None or isinstance(rs, int) else ints(rs)
                args = (q, kn, vn, kc, vc, start, ints(kv_min), pm_t, rs_t)
                close(tfa.batched_cache_flash_attention(*args),
                      tfa.batched_cache_attention_plain(*args))
                calls["batched_cache_attention"] += 1
    torch.cuda.synchronize()
    assert {k: ffi.launch_counts[k] - before[k] for k in before} == calls


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(2, 8, 2, 48, device="cuda")       # head dim 48 is not built
    with pytest.raises(ValueError, match="head dim"):
        tfa.window_flash_attention(q, q, q, torch.tensor([8, 8]))
    q = torch.zeros(16, 4, 64, device="cuda")
    k = torch.zeros(64, 2, 64, device="cuda", dtype=torch.float16)  # no fp16 cache
    with pytest.raises(ValueError, match="bf16 or f32"):
        tfa.causal_cache_flash_attention(q, k, k, 0, 16)
    k = torch.zeros(64, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="out of the cache"):
        tfa.causal_cache_flash_attention(q, k, k, 60, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.causal_cache_flash_attention(q, k.cpu(), k.cpu(), 0, 16)
    # G 3 does not divide the 64-row block: the kernel computes it (dead rows
    # past 3 x 21), where it once refused it
    g = torch.Generator(device="cuda").manual_seed(7)
    qb = torch.randn(2, 64, 12, 64, device="cuda", generator=g)
    kb, vb = (torch.randn(2, 64, 4, 64, device="cuda", generator=g) for _ in range(2))
    km = torch.tensor([0, 9], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(tfa.batched_causal_flash_attention(qb, kb, vb, km),
                               tfa.batched_causal_attention_plain(qb, kb, vb, km),
                               rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_cuda_head_and_probe_kernels_match_plain_versions():
    """K6 (bf16, f32) and K7 (int8 + scales) at R 1, 5, 6, 11 (two row
    groups) and 64 (a serving batch: more rows than one block's shared
    memory holds at once for the f32 rows of h, so two passes), each on the
    route `head_route` picks (the tensor cores above the crossover), V not a
    multiple of any block, an exact tie across blocks that must give the
    first index; K8 and K9 against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    before = dict(ffi.launch_counts)
    calls = {name: 0 for name in before}
    V, H = 50_000 + 13, 1024
    w32 = randn(V, H) * 0.05
    qw = w32.abs().amax(-1) / 127.0
    q8 = torch.round(w32 / qw[:, None]).clamp(-127, 127).to(torch.int8)
    for R in (1, 5, 6, 11, 64):
        h = randn(R, H)
        # a clear winner per row: row r's argmax is planted at (977 r + 3) % V
        want = [(977 * r + 3) % V for r in range(R)]
        for r, v in enumerate(want):
            w32[v] = torch.sign(h[r]) * 0.5
        q8 = torch.round(w32 / qw[:, None]).clamp(-127, 127).to(torch.int8)
        for w, scale in ((w32.to(torch.bfloat16), None), (w32, None), (q8, qw)):
            got = tam.argmax_matvec(h, w, scale)
            assert got.tolist() == want == tam.argmax_matvec_plain(h, w, scale).tolist()
            calls[tam.launch_key(tam.head_route(R, w.dtype), w.dtype)] += 1
    # exact tie across blocks: rows 7 and V - 2 are equal and the largest
    h = randn(1, H)
    w = randn(V, H).to(torch.bfloat16) * 0.05
    w[7] = w[V - 2] = (torch.sign(h[0]) * 0.5).to(torch.bfloat16)
    assert tam.argmax_matvec(h, w).tolist() == [7] == tam.argmax_matvec_plain(h, w).tolist()
    calls["argmax_matvec"] += 1

    x = randn(V, H).to(torch.bfloat16)
    x[V - 1, H - 1] = 9.5                       # the maximum in the last element
    assert float(tprobes.read_all(x, 0.25)) == float(tprobes.read_all_plain(x, 0.25)) == 9.75
    calls["read_all"] += 1
    a, b = randn(256, 256) / 4, randn(256, 256) / 4   # outputs of magnitude ~1
    torch.testing.assert_close(tprobes.probe_mm(a, b), tprobes.probe_mm_plain(a, b),
                               rtol=0, atol=ATOL)
    calls["probe_mm"] += 1
    torch.cuda.synchronize()
    assert {k: ffi.launch_counts[k] - before[k] for k in before} == calls


@pytest.mark.cuda
def test_cuda_tensor_core_head_matches_plain_version():
    """The tensor-core head (bf16 and int8 tables) at R 16 and 64, and at R
    300 (two passes of columns), on planted winners (equal indices) and on
    random inputs (the plain logit at its index within 1e-5 of the row's
    largest |logit| of the maximum: the f32 sums differ only in order); the
    CUDA-core route on the same inputs agrees; an exact tie across tiles
    gives the first index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(3)
    V, H = 50_000 + 13, 1024
    before = dict(ffi.launch_counts)
    calls = {name: 0 for name in before}
    for R in (16, 64, 300):
        w32 = torch.randn(V, H, device="cuda", generator=g) * 0.05
        h = torch.randn(R, H, device="cuda", generator=g)
        qw = w32.abs().amax(-1) / 127.0
        for planted in (False, True):
            want = [(977 * r + 3) % V for r in range(R)]
            if planted:
                for r, v in enumerate(want):
                    w32[v] = torch.sign(h[r]) * 0.5
            q8 = torch.round(w32 / qw[:, None]).clamp(-127, 127).to(torch.int8)
            for w, scale in ((w32.to(torch.bfloat16), None), (q8, qw)):
                got = tam.argmax_matvec(h, w, scale, route="tensor_core")
                core = tam.argmax_matvec(h, w, scale, route="cuda_core")
                calls[tam.launch_key("tensor_core", w.dtype)] += 1
                calls[tam.launch_key("cuda_core", w.dtype)] += 1
                logits = tam.logits_plain(h, w, scale)
                if planted:
                    assert got.tolist() == want == core.tolist()
                for idx in (got, core):
                    short = logits.amax(-1) - logits.gather(1, idx.long()[:, None])[:, 0]
                    assert bool((short <= 1e-5 * logits.abs().amax(-1)).all())
    h = torch.randn(16, H, device="cuda", generator=g)
    w = (torch.randn(V, H, device="cuda", generator=g) * 0.05).to(torch.bfloat16)
    w[7] = w[V - 2] = (torch.sign(h[3]) * 0.5).to(torch.bfloat16)
    assert tam.argmax_matvec(h, w, route="tensor_core")[3].item() == 7
    calls["argmax_matvec_tc"] += 1
    torch.cuda.synchronize()
    assert {k: ffi.launch_counts[k] - before[k] for k in before} == calls


@pytest.mark.cuda
def test_cuda_window_attention_both_routes():
    """B1 at S 13 and 26 (--enc-window-sec 1 and 2), 100 (Qwen2.5-Omni's
    window), 104 (Qwen3-ASR's) -- the window-resident route, each with a
    window's rows in one block and split over two -- and 208 (the
    query-tiled route above 128 rows); ragged lens, one key, an all-pad
    window that must be exactly 0, +-999 junk in every pad key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(5)
    before = ffi.launch_counts["window_attention"]
    n = 0
    kept = tfa.WINDOW_ROW_BLOCKS
    try:
        for S, lens in ((13, [13, 0, 1, 6]), (26, [26, 9, 0, 26]), (100, [100, 64, 0, 17]),
                        (104, [104, 104, 52, 0]), (208, [208, 0, 130, 1])):
            q, k, v = (torch.randn(len(lens), S, 14, 64, device="cuda", generator=g)
                       for _ in range(3))
            for w, m in enumerate(lens):
                k[w, m:], v[w, m:] = 999.0, -999.0
            lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
            want = tfa.window_attention_plain(q, k, v, lens_t)
            for split in (None, 1, 2):
                tfa.WINDOW_ROW_BLOCKS = split
                got = tfa.window_flash_attention(q, k, v, lens_t)
                torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
                assert not got[lens.index(0)].any(), "an all-pad window must give exactly 0"
                n += 1
    finally:
        tfa.WINDOW_ROW_BLOCKS = kept
    torch.cuda.synchronize()
    assert ffi.launch_counts["window_attention"] - before == n


@pytest.mark.cuda
def test_cuda_prefill_attention_both_routes():
    """B2 at the 0.6B head layout (H 16, KH 8) and at G 7 (H 28, KH 4,
    Qwen2.5-Omni's decoder heads: 9 queries per head in a 64-row block, one
    dead row): the --spec verify (T 5 at start 300) and the main prefill (T
    512 from 0, 283 valid rows) on a bf16 cache (two products) and an f32
    cache (three: its K and V split too), both on the tensor cores, +-999
    junk in every row the call must not read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(4)
    before = ffi.launch_counts["causal_cache_attention"]
    n = 0
    cases = [(T, start, valid, kv_min, dtype, heads)
             for T, start, valid, kv_min in ((5, 300, 305, 0), (512, 0, 283, 0), (64, 40, 104, 13))
             for dtype in (torch.bfloat16, torch.float32) for heads in ((16, 8), (28, 4))]
    for T, start, valid, kv_min, dtype, (H, KH) in cases:
        q = torch.randn(T, H, 128, device="cuda", generator=g)
        k = torch.randn(1024, KH, 128, device="cuda", generator=g).to(dtype)
        v = torch.randn(1024, KH, 128, device="cuda", generator=g).to(dtype)
        k[valid:], v[valid:] = 999.0, -999.0
        got = tfa.causal_cache_flash_attention(q, k, v, start, valid, kv_min=kv_min)
        torch.testing.assert_close(
            got, tfa.causal_cache_attention_plain(q, k, v, start, valid, kv_min),
            rtol=0, atol=ATOL)
        n += 1
    torch.cuda.synchronize()
    assert ffi.launch_counts["causal_cache_attention"] - before == n


@pytest.mark.cuda
def test_cuda_prefill_attention_at_stream_delta_shapes():
    """B2 at start > 0 as streaming's KV-reuse prefill runs it: a delta
    block of T 64 to 512 rows written after 9 (the prompt's template) to
    321 reused rows of a 1024-row cache, its last rows pad (kv_valid =
    reused + delta rows), on bf16 and f32 caches, +-999 junk in every row
    past the valid ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(6)
    before = ffi.launch_counts["causal_cache_attention"]
    n = 0
    for T, start, valid in ((64, 300, 357), (128, 9, 130), (128, 300, 421), (256, 300, 549),
                            (512, 321, 800)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(T, 16, 128, device="cuda", generator=g)
            k = torch.randn(1024, 8, 128, device="cuda", generator=g).to(dtype)
            v = torch.randn(1024, 8, 128, device="cuda", generator=g).to(dtype)
            k[valid:], v[valid:] = 999.0, -999.0
            got = tfa.causal_cache_flash_attention(q, k, v, start, valid)
            torch.testing.assert_close(
                got, tfa.causal_cache_attention_plain(q, k, v, start, valid), rtol=0, atol=ATOL)
            n += 1
    torch.cuda.synchronize()
    assert ffi.launch_counts["causal_cache_attention"] - before == n


@pytest.mark.cuda
def test_cuda_new_routes_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h = torch.zeros(16, 1024, device="cuda")
    w = torch.zeros(1000, 1024, device="cuda")
    with pytest.raises(ValueError, match="no tensor-core route"):
        tam.argmax_matvec(h, w, route="tensor_core")
    with pytest.raises(ValueError, match="multiple of 128"):
        tam.argmax_matvec(torch.zeros(16, 96, device="cuda"),
                          torch.zeros(10, 96, device="cuda", dtype=torch.bfloat16),
                          route="tensor_core")
    q = torch.zeros(16, 65, 64, device="cuda")
    k = torch.zeros(64, 1, 64, device="cuda", dtype=torch.bfloat16)    # G 65
    with pytest.raises(ValueError, match="G above 64"):
        tfa.causal_cache_flash_attention(q, k, k, 0, 16)


@pytest.mark.cuda
def test_cuda_decode_attention_plan_boundaries_and_replays():
    """B3 (one launch of a fixed grid: a thread block cluster of 8 blocks
    per KV head, each block's rows worked out from the position it reads
    on the device) at the grid's boundaries: no live row, fewer live rows
    than blocks, a range that is not a multiple of 8, a full context (315
    and 4095 rows), kv_min > 0 and past start; G 1 / 2 / 8, D 64 / 128,
    bf16 and f32 caches; the position as a host int and as a device tensor.
    Then 20 calls back to back and one CUDA-graph replay of them give the
    plain version's output every time (the merge leaves no state behind),
    and one graph replays at start 0 / 315 / 4095 by changing its position
    tensor alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def dev(x):
        return torch.tensor([x], dtype=torch.int32, device="cuda")

    before = ffi.launch_counts["decode_attention"]
    n = 0
    for D, H, KH in ((128, 16, 8), (64, 8, 8), (128, 8, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            for start, kv_min in ((0, 0), (1, 0), (5, 0), (16, 0), (17, 0), (37, 0), (315, 0),
                                  (315, 23), (40, 50), (4095, 0), (4096, 7)):
                q, kn, vn = randn(H, D), randn(KH, D), randn(KH, D)
                k, v = randn(4096, KH, D, dtype=dtype), randn(4096, KH, D, dtype=dtype)
                k[start:], v[start:] = 999.0, -999.0
                want = tfa.decode_attention_plain(q, kn, vn, k, v, start, kv_min)
                for at, lo in ((start, kv_min), (dev(start), dev(kv_min))):
                    torch.testing.assert_close(tfa.decode_flash_attention(q, kn, vn, k, v, at, lo),
                                               want, rtol=0, atol=ATOL)
                    n += 1
    q, kn, vn = randn(16, 128), randn(8, 128), randn(8, 128)
    k, v = randn(4096, 8, 128, dtype=torch.bfloat16), randn(4096, 8, 128, dtype=torch.bfloat16)
    want = tfa.decode_attention_plain(q, kn, vn, k, v, 315, 0)
    at = dev(315)
    outs = [tfa.decode_flash_attention(q, kn, vn, k, v, at) for _ in range(20)]
    n += 20
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = [tfa.decode_flash_attention(q, kn, vn, k, v, at) for _ in range(20)]
    n += 20
    for o in replayed:
        o.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    for o in outs + replayed:
        torch.testing.assert_close(o, want, rtol=0, atol=ATOL)
    for start in (0, 315, 4095, 1):
        at.fill_(start)
        graph.replay()
        torch.cuda.synchronize()
        want = tfa.decode_attention_plain(q, kn, vn, k, v, start, 0)
        for o in replayed:
            torch.testing.assert_close(o, want, rtol=0, atol=ATOL)
    assert ffi.launch_counts["decode_attention"] - before == n


# a checkpoint small enough to build in seconds whose decoder the kernels
# take (head dim 128, G 2; the encoder's head dim 64)
CARD_PRESET = dict(enc_d=128, enc_L=1, enc_heads=2, enc_ffn=256, enc_out=256, conv_hidden=16,
                   dec_h=256, dec_L=2, dec_heads=4, dec_kv=2, head_dim=128, dec_inter=512,
                   vocab=151936)


@pytest.fixture
def card_engine(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    from smolvision_tpu_torch.models import synthetic
    from smolvision_tpu_torch.runtime.engine import Engine

    monkeypatch.setitem(synthetic.PRESETS, "card", CARD_PRESET)
    return Engine(synthetic.build("card", str(tmp_path / "model"), seed=3), device="cuda")


def _eager_capture(step, stream):
    """The decode loop's step run eagerly on every replay (no CUDA graph)."""
    return step


@pytest.mark.cuda
def test_cuda_decode_graph_tokens_equal_eager_across_cache_growth(card_engine, monkeypatch):
    """Single stream: decode_greedy's graph replays give the eager step's
    tokens over 500 steps, which grow the cache from 512 to 1024 rows: the
    growth drops the first graph and captures a second on the new cache.
    Each replay adds its step's launches (L B3, one head) once."""
    from smolvision_tpu_torch.runtime import decode_graph

    eng = card_engine
    ids = list(range(1000, 1100))   # a 128-row prefill block: a 512-row cache

    def greedy():
        eng.reset_kv()
        first, pos = eng.prefill_ids(ids, None, -1, 0)
        out = []
        eng.decode_greedy(first, pos, 501, lambda t: out.append(t) or True)
        return out

    eng.perf.reset()
    before = dict(ffi.launch_counts)
    graph = greedy()
    torch.cuda.synchronize()
    perf = eng.perf
    assert len(graph) == 501, "an EOS cut the run short of the cache growth"
    assert eng._kv_cap == 1024 and eng._loop.kv is eng._kv
    assert perf.graph_captures == 2
    assert eng._loop.graph.launches == {"decode_attention": 2, "argmax_matvec": 1}
    delta = {k: ffi.launch_counts[k] - before[k] for k in before}
    assert delta["decode_attention"] == 2 * perf.decode_steps
    assert delta["argmax_matvec"] == perf.prefills + perf.decode_steps
    assert perf.decode_steps == 500 + perf.wasted_steps
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager = greedy()
    assert graph == eager
    # an EOS inside a chunk (the first token the run shows for the first time
    # after the prefill token): the host learns of it DONE_LAG replays late,
    # and the steps past it change nothing it reads
    k = next((i for i in range(1, len(graph)) if graph[i] not in graph[:i]), None)
    if k is not None:
        from smolvision_tpu_torch.runtime import engine as engine_mod

        for mod in (engine_mod, decode_graph):
            monkeypatch.setattr(mod, "EOS_TOKEN_IDS", (graph[k],))
        eng.perf.reset()
        assert greedy() == graph[:k]
        assert eng.perf.wasted_steps <= decode_graph.DONE_LAG - 1
        assert eng.perf.decode_steps == k + eng.perf.wasted_steps


@pytest.mark.cuda
def test_cuda_batched_decode_graph_tokens_equal_eager(card_engine, monkeypatch):
    """Batched, natural layout with one inactive row, bf16 and int8 caches:
    two chunks of graph replays give the eager step's tokens, counts and
    last tokens."""
    from smolvision_tpu_torch.models import qwen3_decoder as tdec
    from smolvision_tpu_torch.parallel import batch as tbatch
    from smolvision_tpu_torch.runtime import decode_graph

    eng = card_engine
    cfg, p = eng.cfg, eng.dec_params
    B, T, K = 3, 64, 192
    gen = torch.Generator(device="cpu").manual_seed(9)
    ids = torch.randint(0, 150000, (B, T), generator=gen).cuda()
    pads = torch.tensor([0, 12, 40], dtype=torch.int32, device="cuda")
    inputs = dict(rope_offset=pads, kv_min=pads,
                  prompt_max=torch.full((B,), T, dtype=torch.int32, device="cuda"),
                  region_start=torch.full((B,), T, dtype=torch.int32, device="cuda"))

    def run(dtype):
        kv = tdec.make_batched_kv(cfg, B, K, dtype, "cuda")
        tok, kv = tdec.batched_prefill(p, cfg, p["embed"][ids].float(), kv, -pads, pads)
        loop = tbatch.batched_decode_loop(p, cfg, kv, B, natural=True)
        out, pos = [], T
        for steps in (40, 24):
            buf, count, replays = loop.run(tok, pos, steps, row_active=[True, False, True],
                                           **inputs)
            out.append((buf.tolist(), count, loop.tok.tolist()))
            tok, pos = loop.tok, pos + count
        return out, loop

    for dtype in (torch.bfloat16, torch.int8):
        graph, loop = run(dtype)
        assert loop.graph.launches == {"argmax_matvec": 1}
        with monkeypatch.context() as m:
            m.setattr(decode_graph, "capture", _eager_capture)
            eager, _ = run(dtype)
        assert graph == eager


@pytest.mark.cuda
def test_cuda_probe_mm_ragged_shapes():
    """K9 (register-tiled f32, 16 x 32 output blocks, 128-deep k tiles) at
    shapes that are multiples of nothing, including K not a multiple of 4
    (the 4-byte copy route) and K 0, against torch.matmul in full f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(6)
    before = ffi.launch_counts["probe_mm"]
    shapes = ((256, 256, 256), (1, 1, 1), (17, 33, 5), (100, 70, 300), (255, 257, 129),
              (64, 64, 0), (300, 40, 1024), (33, 100, 64))
    for M, N, K in shapes:
        a = torch.randn(M, K, device="cuda", generator=g) / 4
        b = torch.randn(K, N, device="cuda", generator=g) / 4
        torch.testing.assert_close(tprobes.probe_mm(a, b), torch.matmul(a, b), rtol=0,
                                   atol=ATOL)
    torch.cuda.synchronize()
    assert ffi.launch_counts["probe_mm"] - before == len(shapes)


def _untied_card_model(tmp_path, monkeypatch, **preset) -> str:
    """The card checkpoint (full vocab; `preset` overrides CARD_PRESET) with
    a separate random lm_head: a tied random head greedy-decodes one token
    over and over, which the stream's recovery reset swallows; an untied
    one decodes varied tokens, so the prefix conditioning and the KV reuse
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    import json
    import os

    from smolvision_tpu_torch.io.safetensors import MultiSafetensors, write_safetensors
    from smolvision_tpu_torch.models import synthetic

    monkeypatch.setitem(synthetic.PRESETS, "card", dict(CARD_PRESET, **preset))
    model = synthetic.build("card", str(tmp_path / "model"), seed=3, full_vocab=True)
    with MultiSafetensors(model) as r:
        tensors = {k: r.get(k).clone() for k in r.names()}
    embed = tensors["thinker.model.embed_tokens.weight"]
    g = torch.Generator().manual_seed(4)
    tensors["thinker.lm_head.weight"] = (torch.randn(embed.shape, generator=g) * 0.1).to(
        embed.dtype)
    write_safetensors(os.path.join(model, "model.safetensors"), tensors)
    path = os.path.join(model, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["thinker_config"]["text_config"]["tie_word_embeddings"] = False
    with open(path, "w") as f:
        json.dump(cfg, f)
    return model


@pytest.fixture
def card_stream_engine(tmp_path, monkeypatch):
    """An engine on the untied card checkpoint (`_untied_card_model`)."""
    from smolvision_tpu_torch.runtime.engine import Engine

    return Engine(_untied_card_model(tmp_path, monkeypatch), device="cuda")


@pytest.mark.cuda
def test_cuda_stream_captures_one_graph_per_cache(card_stream_engine, monkeypatch):
    """A 10-chunk stream (20 s, 2 s chunks) on the card: every chunk after
    the first prefills its delta through B2 at start > 0 into the cache the
    decode loop's CUDA graph holds, and decodes by replaying that graph; a
    graph is captured once per cache (1 + its growths), not per chunk.  The
    chunks' tokens equal those of the same stream with eager steps."""
    import numpy as np

    from smolvision_tpu_torch.models import qwen3_decoder as tdec
    from smolvision_tpu_torch.runtime import decode_graph
    from smolvision_tpu_torch.runtime import stream

    eng = card_stream_engine
    eng.past_text_conditioning = True
    rng = np.random.default_rng(7)
    t = np.arange(20 * 16000) / 16000
    audio = (0.25 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
             + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    make = tdec.make_kv_cache
    allocs = []
    monkeypatch.setattr(tdec, "make_kv_cache", lambda *a, **k: allocs.append(1) or make(*a, **k))

    def run():
        eng.reset_kv()
        allocs.clear()
        eng.token_cb = lambda piece: None
        state = stream.StreamState(eng, audio, None)
        chunks = []
        while state.active():
            w = state.begin_chunk()
            if w is not None:
                stream.run_solo_chunk(state, w)
                chunks.append((w.reused, list(state.raw_tokens)))
        return chunks, state.finalize()

    graph = run()
    perf = eng.perf
    assert len(graph[0]) == 10
    assert perf.reuse_prefills >= 1 and perf.decode_steps > 0
    assert 1 <= perf.graph_captures <= len(allocs), (perf.graph_captures, len(allocs))
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager = run()
    assert graph == eager


@pytest.mark.cuda
def test_cuda_batched_cache_attention_at_multistream_rounds():
    """B5 as multistream's rounds run it: per-row prompt_max, region_start
    = pcap, a cache of pcap plus the 64-row decode region.  A synthetic
    round (B 8, pcap 768, prompt_max 600-698) with a W 128 block at S 256
    (the cache half, on bf16 and f32 caches) and the full-cap block (S 0,
    W 768, nothing reused); then the blocks the eight-clip run gives at
    S > 0 (S 64, W 256 and 512, pcap 640; S 192, W 256, pcap 512 on the
    --f32 run's cache), one with a pad row (prompt_max 0).  +-999 in every
    cache column outside each row's window: the end pad [prompt_max, pcap),
    the decode region, and the block's own rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(8)
    H, KH, D = 16, 8, 128
    synthetic = [600 + 14 * b for b in range(8)]
    cases = [(256, 128, 768, synthetic, torch.bfloat16), (256, 128, 768, synthetic, torch.float32),
             (0, 768, 768, synthetic, torch.bfloat16),
             (64, 256, 640, [301, 287], torch.bfloat16), (64, 512, 640, [560, 533], torch.bfloat16),
             (64, 512, 640, [560, 533, 0, 0], torch.bfloat16),
             (192, 256, 512, [421, 440], torch.float32)]
    before = ffi.launch_counts["batched_cache_attention"]
    for S, W, pcap, prompt_max, dtype in cases:
        B, kcap = len(prompt_max), pcap + 64
        pm = torch.tensor(prompt_max, dtype=torch.int32, device="cuda")
        km = torch.zeros(B, dtype=torch.int32, device="cuda")
        cols = torch.arange(kcap, device="cuda")
        q = torch.randn(B, W, H, D, device="cuda", generator=g)
        kn, vn = (torch.randn(B, W, KH, D, device="cuda", generator=g) for _ in range(2))
        kv = torch.randn(2, 2, B, KH, kcap, D, device="cuda", generator=g).to(dtype)
        kc, vc = kv[1, 0], kv[1, 1]
        dead = ~((cols[None, :] < S) & ((cols[None, :] < pm[:, None].long())
                                         | (cols[None, :] >= pcap)))       # [B, kcap]
        kc[dead[:, None, :].expand(B, KH, kcap)] = 999.0
        vc[dead[:, None, :].expand(B, KH, kcap)] = -999.0
        args = (q, kn, vn, kc, vc, S, km, pm, pcap)
        torch.testing.assert_close(tfa.batched_cache_flash_attention(*args),
                                   tfa.batched_cache_attention_plain(*args), rtol=0, atol=ATOL)
    torch.cuda.synchronize()
    assert ffi.launch_counts["batched_cache_attention"] - before == len(cases)


@pytest.mark.cuda
def test_cuda_batched_cache_attention_device_start():
    """B5 with its start an int32 / int64 device tensor (multistream's round
    prefill graph's form) at starts 0, 64, 192 and 640 against the plain
    version at the host int, G 2 and G 7; then one CUDA graph of it,
    captured at start 256 and replayed at each start by changing the start
    tensor alone.  +-999 in every cache column outside each row's window,
    the columns at and past the start included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(18)
    B, W, pcap, kcap = 3, 64, 704, 768
    pm = torch.tensor([700, 350, 600], dtype=torch.int32, device="cuda")
    km = torch.tensor([0, 9, 0], dtype=torch.int32, device="cuda")
    rs = torch.full((B,), pcap, dtype=torch.int32, device="cuda")
    cols = torch.arange(kcap, device="cuda")

    def case(H, KH, start):
        q = torch.randn(B, W, H, 128, device="cuda", generator=g)
        kn, vn = (torch.randn(B, W, KH, 128, device="cuda", generator=g) for _ in range(2))
        kv = torch.randn(2, B, KH, kcap, 128, device="cuda", generator=g).to(torch.bfloat16)
        dead = ~((cols[None, :] >= km[:, None]) & (cols[None, :] < start)
                 & ((cols[None, :] < pm[:, None]) | (cols[None, :] >= pcap)))
        kv[0][dead[:, None, :].expand(B, KH, kcap)] = 999.0
        kv[1][dead[:, None, :].expand(B, KH, kcap)] = -999.0
        return q, kn, vn, kv

    for H, KH in ((16, 8), (28, 4)):
        for i, start in enumerate((0, 64, 192, 640)):
            q, kn, vn, kv = case(H, KH, start)
            at = torch.tensor([start], dtype=(torch.int32, torch.int64)[i % 2], device="cuda")
            torch.testing.assert_close(
                tfa.batched_cache_flash_attention(q, kn, vn, kv[0], kv[1], at, km, pm, rs),
                tfa.batched_cache_attention_plain(q, kn, vn, kv[0], kv[1], start, km, pm, rs),
                rtol=0, atol=ATOL)
    q, kn, vn, kv = case(16, 8, 256)
    at = torch.tensor([256], dtype=torch.int64, device="cuda")
    tfa.batched_cache_flash_attention(q, kn, vn, kv[0], kv[1], at, km, pm, rs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tfa.batched_cache_flash_attention(q, kn, vn, kv[0], kv[1], at, km, pm, rs)
    for start in (256, 0, 64, 640):
        kv.copy_(case(16, 8, start)[3])
        at.fill_(start)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out, tfa.batched_cache_attention_plain(q, kn, vn, kv[0], kv[1], start, km, pm, rs),
            rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_cuda_multistream_captures_one_graph_per_cache(card_stream_engine, monkeypatch):
    """Two sessions (12 and 8 s) through the batched coordinator on the
    card: one delta prefill (B5 per layer) and one batched decode per
    round, the decode graph captured at most once per cache (allocation,
    growths, compactions), never per round; the rounds' tokens equal those
    of the same run with eager steps.  The threaded mode (a thread per
    session, taking turns on the card a chunk at a time) gives each
    session's solo stream, and its launches are counted."""
    import numpy as np

    from smolvision_tpu_torch.runtime import decode_graph
    from smolvision_tpu_torch.runtime import multistream
    from smolvision_tpu_torch.runtime import stream

    eng = card_stream_engine
    eng.past_text_conditioning = True
    rng = np.random.default_rng(9)
    clips = []
    for sec, f in ((12, 200), (8, 260)):
        t = np.arange(sec * 16000) / 16000
        clips.append((0.25 * np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
                      + 0.01 * rng.standard_normal(len(t))).astype(np.float32))
    log = []
    finish = stream.StreamState.finish_chunk

    def spy(state, w, *args):
        finish(state, w, *args)
        log.append((id(state.engine), state.chunk_idx - 1, list(state.raw_tokens)))

    monkeypatch.setattr(stream.StreamState, "finish_chunk", spy)

    def run():
        log.clear()
        eng.perf.reset()
        texts = multistream.run_streams(eng, clips)
        order = list(dict.fromkeys(v for v, _, _ in log))
        return texts, [[c[1:] for c in log if c[0] == v] for v in order]

    before = dict(ffi.launch_counts)
    graph = run()
    torch.cuda.synchronize()
    perf, record = eng.perf, eng.perf.multistream
    L = eng.cfg.dec_layers
    assert len(record["rounds"]) == 6 and perf.delta_prefills == 6
    assert 1 <= perf.graph_captures <= record["caches"], (perf.graph_captures, record)
    assert ffi.launch_counts["batched_cache_attention"] - before["batched_cache_attention"] \
        == L * perf.delta_prefills
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager = run()
    assert graph == eager

    solo = []
    for c in clips:
        view = multistream.clone_session(eng)
        view.token_cb = lambda piece: None
        solo.append(stream.transcribe_stream(view, c))
    monkeypatch.setenv("SMOLVISION_BATCH_STREAMS", "0")
    before = dict(ffi.launch_counts)
    views = []
    clone = multistream.clone_session
    monkeypatch.setattr(multistream, "clone_session", lambda e: views.append(clone(e)) or views[-1])
    assert multistream.run_streams(eng, clips) == solo
    torch.cuda.synchronize()
    steps = sum(v.perf.decode_steps for v in views)
    assert steps > 0 and all(v.perf.graph_captures >= 1 for v in views)
    assert ffi.launch_counts["decode_attention"] - before["decode_attention"] == L * steps


@pytest.mark.cuda
def test_cuda_prefill_attention_at_a_device_start():
    """B2 reading start and kv_valid from device memory (int32 and int64
    tensors), at the --spec verify's shape (T 5) and the stream's delta
    shapes (T 128, 256), on bf16 and f32 caches: against its plain version
    at the same host ints; then one CUDA graph of each, captured at one
    start, replayed at four by changing the two tensors alone, with +-999
    in every row past each replay's valid rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(9)
    before = ffi.launch_counts["causal_cache_attention"]
    n = 0
    for T in (5, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(T, 16, 128, device="cuda", generator=g)
            k = torch.randn(1024, 8, 128, device="cuda", generator=g).to(dtype)
            v = torch.randn(1024, 8, 128, device="cuda", generator=g).to(dtype)
            clean_k, clean_v = k.clone(), v.clone()

            def junk(valid):
                k.copy_(clean_k)
                v.copy_(clean_v)
                k[valid:], v[valid:] = 999.0, -999.0

            for itype in (torch.int32, torch.int64):
                start, valid = 300, 300 + T - 3
                junk(valid)
                at = torch.tensor([start], dtype=itype, device="cuda")
                torch.testing.assert_close(
                    tfa.causal_cache_flash_attention(q, k, v, at, at + (T - 3)),
                    tfa.causal_cache_attention_plain(q, k, v, start, valid), rtol=0, atol=ATOL)
                n += 1
            at = torch.tensor([300], dtype=torch.int32, device="cuda")
            vt = at + T
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                tfa.causal_cache_flash_attention(q, k, v, at, vt)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = tfa.causal_cache_flash_attention(q, k, v, at, vt)
            n += 2
            for start, valid in ((300, 300 + T), (0, T - 1), (17, 17 + T), (1024 - T, 1000)):
                junk(valid)
                at.fill_(start)
                vt.fill_(valid)
                out.fill_(float("nan"))
                graph.replay()
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    out, tfa.causal_cache_attention_plain(q, k, v, start, valid), rtol=0,
                    atol=ATOL)
            del graph
    torch.cuda.synchronize()
    assert ffi.launch_counts["causal_cache_attention"] - before == n


@pytest.mark.cuda
def test_cuda_spec_graph_tokens_equal_eager_across_cache_growth(tmp_path, monkeypatch):
    """--spec as one CUDA graph per cache, a replay per speculative
    iteration: 130 tokens (three chunks) from a 150-id prompt with no
    headroom past the prefill block, so the cache grows 256 -> 512 rows
    before the second chunk (a second capture).  The tokens equal the eager
    iterations' and plain greedy's (f32 weights; a 512-wide decoder, which
    the int8 draft head K7 takes); a replay launches the
    iteration's kernels once: SPEC_DRAFT x (L B3 + 1 K7) + L B2 + 1 K6 at
    R SPEC_DRAFT + 1; the counters and launches agree, wasted replays
    included."""
    from smolvision_tpu_torch.kernels import argmax_matvec as tam_
    from smolvision_tpu_torch.runtime import decode_graph
    from smolvision_tpu_torch.runtime import engine as engine_mod
    from smolvision_tpu_torch.runtime.engine import Engine

    model = _untied_card_model(tmp_path, monkeypatch, dec_h=512, enc_out=512)
    eng = Engine(model, param_dtype=torch.float32, kv_dtype=torch.float32, device="cuda",
                 spec=True)
    monkeypatch.setattr(engine_mod, "KV_HEADROOM", 0)
    ids = list(range(2000, 2150))
    caps = []
    run = decode_graph.SpecLoop.run

    def spy(self, *args):
        caps.append(self.capacity)
        return run(self, *args)

    monkeypatch.setattr(decode_graph.SpecLoop, "run", spy)

    def greedy(spec=True):
        eng.spec = spec
        eng.reset_kv()
        first, pos = eng.prefill_ids(ids, None, -1, 0)
        out = []
        eng.decode_greedy(first, pos, 131, lambda t: out.append(t) or True)
        return out

    eng.perf.reset()
    before = dict(ffi.launch_counts)
    graph = greedy()
    torch.cuda.synchronize()
    perf, L, n = eng.perf, eng.cfg.dec_layers, engine_mod.SPEC_DRAFT
    assert len(graph) == 131, "an EOS cut the run short of three chunks"
    assert caps == [256, 512, 512] and perf.graph_captures == 2
    head = tam_.launch_key(tam_.head_route(n + 1, torch.float32), torch.float32)
    draft_head = tam_.launch_key(tam_.head_route(1, torch.int8), torch.int8)
    assert eng._loop.graph.launches == {"decode_attention": n * L, draft_head: n,
                                        "causal_cache_attention": L, head: 1}
    iters = perf.spec_iters + perf.wasted_steps
    delta = {k: ffi.launch_counts[k] - before[k] for k in before if ffi.launch_counts[k] != before[k]}
    prefill_head = tam_.launch_key(tam_.head_route(1, torch.float32), torch.float32)
    want = {"decode_attention": n * L * iters, draft_head: n * iters,
            "causal_cache_attention": L * (perf.prefills + iters)}
    want[head] = want.get(head, 0) + iters
    want[prefill_head] = want.get(prefill_head, 0) + perf.prefills
    assert delta == want
    assert perf.decode_steps == n * perf.spec_iters and perf.spec_tokens == 130
    assert perf.wasted_steps <= 3 * (decode_graph.DONE_LAG - 1)
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager = greedy()
    assert graph == eager == greedy(spec=False)


@pytest.mark.cuda
def test_cuda_stream_prefill_graphs_equal_eager(card_stream_engine, monkeypatch):
    """A 20 s stream whose greedy prefills go through PrefillGraph: a (cache,
    block rows) key's first prefill eager, its second captured, later ones
    replayed.  Chunks and the cache rows the stream leaves equal those of
    the same stream run eagerly throughout; captures at most the distinct
    keys, and some chunk replays a prefill graph."""
    import numpy as np

    from smolvision_tpu_torch.runtime import decode_graph
    from smolvision_tpu_torch.runtime import stream

    eng = card_stream_engine
    eng.past_text_conditioning = True
    rng = np.random.default_rng(7)
    t = np.arange(20 * 16000) / 16000
    audio = (0.25 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
             + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    keys = []
    init = decode_graph.PrefillGraph.__init__

    def spy(self, forward, embeds, perf):
        keys.append(embeds.shape[0])
        init(self, forward, embeds, perf)

    monkeypatch.setattr(decode_graph.PrefillGraph, "__init__", spy)

    def run():
        eng.reset_kv()
        eng.perf.reset()
        keys.clear()
        eng.token_cb = lambda piece: None
        state = stream.StreamState(eng, audio, None)
        chunks = []
        while state.active():
            w = state.begin_chunk()
            if w is not None:
                stream.run_solo_chunk(state, w)
                chunks.append((w.reused, list(state.raw_tokens)))
        torch.cuda.synchronize()
        return chunks, state.finalize(), eng._kv.clone()

    graph = run()
    perf = eng.perf
    assert 1 <= perf.prefill_captures <= len(keys), (perf.prefill_captures, keys)
    assert perf.prefill_replays >= 1 and perf.prefills == len(graph[0])
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager = run()
    assert graph[:2] == eager[:2]
    torch.testing.assert_close(graph[2], eager[2])


@pytest.mark.cuda
def test_cuda_decode_attention_at_group_7():
    """B3 at Qwen2.5-Omni's decoder heads (H 28, KH 4, D 128: G 7, which the
    kernel rounds up to 8 with a dead eighth head per KV head) on a bf16
    cache: at the 20 s clip's decode start (about 1090 rows), at a cluster
    plan boundary (a multiple of the 8 blocks and one past it), a long
    context, with the position a host int and a device tensor; then one
    CUDA graph of it replayed at four starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def dev(x):
        return torch.tensor([x], dtype=torch.int32, device="cuda")

    H, KH, D, K = 28, 4, 128, 4096
    before = ffi.launch_counts["decode_attention"]
    n = 0
    for start, kv_min in ((0, 0), (1, 0), (7, 0), (64, 0), (65, 0), (1089, 0), (1090, 13),
                          (2330, 0), (4095, 0)):
        q, kn, vn = randn(H, D), randn(KH, D), randn(KH, D)
        k, v = randn(K, KH, D, dtype=torch.bfloat16), randn(K, KH, D, dtype=torch.bfloat16)
        k[start:], v[start:] = 999.0, -999.0
        want = tfa.decode_attention_plain(q, kn, vn, k, v, start, kv_min)
        for at, lo in ((start, kv_min), (dev(start), dev(kv_min))):
            torch.testing.assert_close(tfa.decode_flash_attention(q, kn, vn, k, v, at, lo), want,
                                       rtol=0, atol=ATOL)
            n += 1
    q, kn, vn = randn(H, D), randn(KH, D), randn(KH, D)
    k, v = randn(K, KH, D, dtype=torch.bfloat16), randn(K, KH, D, dtype=torch.bfloat16)
    at = dev(1089)
    tfa.decode_flash_attention(q, kn, vn, k, v, at)
    n += 1
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tfa.decode_flash_attention(q, kn, vn, k, v, at)
    n += 1
    for start in (0, 1089, 4095, 65):
        at.fill_(start)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, tfa.decode_attention_plain(q, kn, vn, k, v, start, 0),
                                   rtol=0, atol=ATOL)
    assert ffi.launch_counts["decode_attention"] - before == n


def _thinker_tokens(eng, **settings):
    """The token ids one thinker run on `eng` emits, by its text prompt."""
    ids = []
    real = eng.tokenizer

    class Recorder:
        def encode(self, text):
            return real.encode(text)

        def decode_piece(self, tid):
            ids.append(int(tid))
            return real.decode_piece(tid)

    for k, v in settings.items():
        setattr(eng, k, v)
    eng._tokenizer = Recorder()
    try:
        eng.thinker_generate(None, "tell me a long story")
    finally:
        eng._tokenizer = real
    torch.cuda.synchronize()
    return ids


@pytest.mark.cuda
def test_cuda_sample_graph_tokens_equal_eager_across_cache_growth(card_stream_engine,
                                                                   monkeypatch):
    """The sampled thinker at its defaults (temperature 0.7, top-k 40,
    penalty 1.1, seed 0) over 300 tokens, which grow the cache from 256 to
    512 rows (no headroom past the prefill block): the graph replays give
    the eager steps' tokens (the draw is keyed by seed and cache row, so a
    capture moves nothing), two captures, one per cache, each replay L B3
    launches and no head; another seed gives other tokens."""
    from smolvision_tpu_torch.runtime import decode_graph
    from smolvision_tpu_torch.runtime import engine as engine_mod

    eng = card_stream_engine
    monkeypatch.setattr(engine_mod, "KV_HEADROOM", 0)
    settings = dict(thinker_max_tokens=300, temperature=0.7, top_k=40,
                    repetition_penalty=1.1, seed=0)
    before = dict(ffi.launch_counts)
    graph = _thinker_tokens(eng, **settings)
    perf = eng.perf
    assert len(graph) == 300, "an EOS cut the run short of the cache growth"
    assert eng._kv_cap == 512 and isinstance(eng._loop, decode_graph.SampleLoop)
    assert perf.graph_captures == 2 and perf.wasted_steps <= 5 * (decode_graph.DONE_LAG - 1)
    assert eng._loop.graph.launches == {"decode_attention": eng.cfg.dec_layers}
    delta = {k: ffi.launch_counts[k] - before[k] for k in before if ffi.launch_counts[k] != before[k]}
    assert delta == {"decode_attention": eng.cfg.dec_layers * perf.decode_steps,
                     "causal_cache_attention": eng.cfg.dec_layers}
    assert perf.decode_steps == perf.logits_steps == 299 + perf.wasted_steps
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager = _thinker_tokens(eng, **settings)
    assert graph == eager
    assert _thinker_tokens(eng, **dict(settings, seed=1)) != graph


@pytest.mark.cuda
def test_cuda_q25_thinker_graph_equals_eager(tmp_path, monkeypatch):
    """A tiny Qwen2.5-Omni-shaped checkpoint on the card (a QKV bias, no q/k
    norms, an untied head; G 7 in the decoder, head dim 128; the Conv1D
    tower at 100-token windows, head dim 64): the greedy thinker on a 3 s
    clip and the sampled one on text, each as CUDA graphs equal to the
    eager steps; the encoder runs B1 once per layer."""
    import numpy as np

    from smolvision_tpu_torch.models import synthetic
    from smolvision_tpu_torch.runtime import decode_graph
    from smolvision_tpu_torch.runtime.engine import Engine

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    monkeypatch.setitem(synthetic.PRESETS, "card-q25", dict(
        enc_d=128, enc_L=2, enc_heads=2, enc_ffn=256, enc_out=256, conv_hidden=0, dec_h=256,
        dec_L=2, dec_heads=7, dec_kv=1, head_dim=128, dec_inter=512, vocab=152064, q25=True))
    eng = Engine(synthetic.build("card-q25", str(tmp_path / "model"), seed=4, full_vocab=True),
                 device="cuda")
    t = np.arange(3 * 16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)

    def run(temperature, samples, text):
        ids = []
        real = eng.tokenizer

        class Recorder:
            def encode(self, s):
                return real.encode(s)

            def decode_piece(self, tid):
                ids.append(int(tid))
                return real.decode_piece(tid)

        eng.temperature, eng.thinker_max_tokens = temperature, 80
        eng._tokenizer = Recorder()
        try:
            eng.thinker_generate(samples, text)
        finally:
            eng._tokenizer = real
        torch.cuda.synchronize()
        return ids

    for temperature, samples, text in ((0.0, audio, None), (0.7, None, "hi")):
        before = ffi.launch_counts["window_attention"]
        graph = run(temperature, samples, text)
        assert ffi.launch_counts["window_attention"] - before == (
            eng.cfg.enc_layers if samples is not None else 0)
        assert eng.perf.graph_captures == 1 and len(graph) > 0
        with monkeypatch.context() as m:
            m.setattr(decode_graph, "capture", _eager_capture)
            eager = run(temperature, samples, text)
        assert graph == eager


# a card-shaped MoE decoder: G 8 (16 heads over 2 KV heads), head dim 128,
# hidden 512, 16 experts top-8 in both layers
CARD_MOE = dict(dec_h=512, dec_heads=16, dec_kv=2, enc_out=512,
                moe=dict(num_experts=16, top_k=8, moe_inter=128))


@pytest.fixture
def card_moe_engine(tmp_path, monkeypatch):
    """An engine on the untied card-shaped MoE checkpoint."""
    from smolvision_tpu_torch.runtime.engine import Engine

    return Engine(_untied_card_model(tmp_path, monkeypatch, **CARD_MOE), device="cuda")


@pytest.mark.cuda
def test_cuda_moe_decode_graphs_equal_eager(card_moe_engine, monkeypatch):
    """The MoE decoder's graph steps against the same steps run eagerly:
    the single-stream loop (the gather of the chosen experts) over 200
    tokens after a prefill whose graph (the dense form above 4 rows) is
    captured on its second call, and the sampled thinker; each replay adds
    its step's launches (L B3, one head; B2 L times per prefill)."""
    from smolvision_tpu_torch.runtime import decode_graph

    eng = card_moe_engine
    L = eng.cfg.dec_layers
    assert eng.dec_params["moe_layers"] == (True, True)
    ids = list(range(1000, 1100))

    def greedy():
        eng.reset_kv()
        for _ in range(2):   # the prefill graph is captured on its second call
            first, pos = eng.prefill_ids(ids, None, -1, 0)
        out = []
        eng.decode_greedy(first, pos, 201, lambda t: out.append(t) or True)
        torch.cuda.synchronize()
        return out

    eng.perf.reset()
    before = dict(ffi.launch_counts)
    graph = greedy()
    perf = eng.perf
    assert len(graph) > 20 and len(set(graph)) > 5
    assert perf.prefill_captures == 1 and perf.graph_captures == 1
    assert eng._loop.graph.launches == {"decode_attention": L, "argmax_matvec": 1}
    delta = {k: ffi.launch_counts[k] - before[k] for k in before}
    assert delta["decode_attention"] == L * perf.decode_steps
    assert delta["causal_cache_attention"] == L * perf.prefills
    assert delta["argmax_matvec"] == perf.prefills + perf.decode_steps
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager = greedy()
    assert graph == eager
    settings = dict(temperature=0.7, top_k=40, repetition_penalty=1.1, seed=0,
                    thinker_max_tokens=80)
    sampled = _thinker_tokens(eng, **settings)
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        assert _thinker_tokens(eng, **settings) == sampled
    assert len(sampled) > 0


@pytest.mark.cuda
def test_cuda_moe_batched_step_at_b6_graph_equals_eager(card_moe_engine, monkeypatch):
    """The batched decode step at B 6 (the dense form: above 4 rows a graph
    step reads every expert): two chunks of graph replays give the eager
    step's tokens; one head launch per replay."""
    from smolvision_tpu_torch.kernels import argmax_matvec as am
    from smolvision_tpu_torch.models import qwen3_decoder as tdec
    from smolvision_tpu_torch.parallel import batch as tbatch
    from smolvision_tpu_torch.runtime import decode_graph

    eng = card_moe_engine
    cfg, p = eng.cfg, eng.dec_params
    B, T, K = 6, 64, 256
    gen = torch.Generator(device="cpu").manual_seed(9)
    ids = torch.randint(0, 150000, (B, T), generator=gen).cuda()
    pads = torch.tensor([0, 12, 40, 3, 0, 7], dtype=torch.int32, device="cuda")

    def run():
        kv = tdec.make_batched_kv(cfg, B, K, torch.bfloat16, "cuda")
        tok, kv = tdec.batched_prefill(p, cfg, p["embed"][ids].float(), kv, -pads, pads)
        loop = tbatch.batched_decode_loop(p, cfg, kv, B)
        out, pos = [], T
        for steps in (40, 24):
            buf, count, _ = loop.run(tok, pos, steps, rope_offset=pads, kv_min=pads)
            out.append((buf.tolist(), count, loop.tok.tolist()))
            tok, pos = loop.tok, pos + count
        torch.cuda.synchronize()
        return out, loop

    graph, loop = run()
    head = am.launch_key(am.head_route(B, torch.bfloat16), torch.bfloat16)
    assert loop.graph.launches == {head: 1}
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager, _ = run()
    assert graph == eager


@pytest.mark.cuda
def test_cuda_moe_captured_forward_with_overflow_equals_eager():
    """An MoE FFN of the 30B's routing (128 experts, top-8) at T 64, its
    router biased so every token picks the same eight experts: the eager
    forward dispatches (queues of 8), reads the drop count and falls back
    to dense; the same forward captured as a CUDA graph (graph-safe) runs
    dense with no host read.  Equal outputs."""
    import dataclasses

    from smolvision_tpu_torch.config import QWEN3_OMNI_30B
    from smolvision_tpu_torch.models import moe

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    E, H, MI, T = 128, 512, 128, 64
    cfg = dataclasses.replace(QWEN3_OMNI_30B, dec_hidden=H, moe_intermediate=MI)
    g = torch.Generator(device="cuda").manual_seed(5)
    lp = {"router": torch.randn(E, H, device="cuda", generator=g) * 0.05,
          "e_gate": (torch.randn(E, MI, H, device="cuda", generator=g) * 0.05).bfloat16(),
          "e_up": (torch.randn(E, MI, H, device="cuda", generator=g) * 0.05).bfloat16(),
          "e_down": (torch.randn(E, H, MI, device="cuda", generator=g) * 0.05).bfloat16()}
    x = torch.randn(T, H, device="cuda", generator=g).abs() + 0.1
    lp["router"][:8] += 1.0
    top_idx, top_w = moe.route(x, lp["router"], cfg)
    _, n_dropped = moe.capacity_dispatch(x.bfloat16(), lp, top_idx, top_w,
                                         torch.ones(T, dtype=torch.bool, device="cuda"))
    assert int(n_dropped) == T * 8 - 8 * moe.capacity(T, 8, E)
    eager = moe.moe_ffn(x, lp, cfg)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        moe.moe_ffn(x, lp, cfg, graph_safe=True)   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe_ffn(x, lp, cfg, graph_safe=True)
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, eager, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_int8_moe_gather_graph_replay_equals_eager():
    """The --spec draft's MoE step on int8 experts (QuantW stacks, 16 experts
    top-8): the gather with device indices (index_select of q and s)
    captured once as a CUDA graph and replayed on three inputs equals the
    same forward run eagerly."""
    import dataclasses

    from smolvision_tpu_torch.config import QWEN3_OMNI_30B
    from smolvision_tpu_torch.models import moe
    from smolvision_tpu_torch.ops.quant import QuantW, quantize_weight

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    E, H, MI = 16, 512, 128
    cfg = dataclasses.replace(QWEN3_OMNI_30B, num_experts=E, dec_hidden=H, moe_intermediate=MI)
    g = torch.Generator(device="cuda").manual_seed(6)
    lp = {"router": torch.randn(E, H, device="cuda", generator=g) * 0.05}
    for k, shape in (("e_gate", (E, MI, H)), ("e_up", (E, MI, H)), ("e_down", (E, H, MI))):
        lp[k] = quantize_weight(torch.randn(*shape, device="cuda", generator=g) * 0.05)
        assert isinstance(lp[k], QuantW) and lp[k].q.dtype == torch.int8
    inputs = [torch.randn(1, H, device="cuda", generator=g) for _ in range(3)]
    x = inputs[0].clone()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        moe.moe_ffn(x, lp, cfg, graph_safe=True)   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe_ffn(x, lp, cfg, graph_safe=True)
    for inp in inputs:
        x.copy_(inp)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, moe.moe_ffn(inp, lp, cfg, graph_safe=True))


def _offload_model(tmp_path, monkeypatch) -> str:
    """tiny-moe's routing (4 experts top-2 in both layers) at the card
    checkpoint's widths (head dims the kernels take), f32."""
    from smolvision_tpu_torch.models import synthetic

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    monkeypatch.setitem(synthetic.PRESETS, "card-moe", dict(
        CARD_PRESET, moe=dict(synthetic.PRESETS["tiny-moe"]["moe"])))
    return synthetic.build("card-moe", str(tmp_path / "card-moe"), seed=1, dtype="f32",
                           full_vocab=True)


@pytest.mark.cuda
def test_cuda_offload_forward_equals_resident(tmp_path, monkeypatch):
    """--moe-offload on a tiny MoE in f32 on the card: prefill logits within
    1e-4 of the resident engine's (sums in another order), and the same
    greedy tokens; no expert stack on the device."""
    from smolvision_tpu_torch.runtime.engine import Engine

    model = _offload_model(tmp_path, monkeypatch)
    res = Engine(model, param_dtype=torch.float32, kv_dtype=torch.float32, device="cuda")
    off = Engine(model, param_dtype=torch.float32, kv_dtype=torch.float32, device="cuda",
                 moe_offload=True)
    assert off.dec_params["layers"]["e_gate"] is None
    ids = list(range(1000, 1100))
    out = []
    for eng in (res, off):
        eng.reset_kv()
        logits, _ = eng.prefill_ids(ids, None, -1, 0, greedy=False)
        eng.reset_kv()
        first, pos = eng.prefill_ids(ids, None, -1, 0)
        toks = []
        eng.decode_greedy(first, pos, 24, lambda t: toks.append(t) or True)
        out.append((logits, toks))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-4, atol=1e-4)
    assert out[1][1] == out[0][1] and len(out[0][1]) > 1
    assert off.expert_store.stats["router_reads"] == 2 * off.perf.decode_steps


@pytest.mark.cuda
def test_cuda_offload_pinned_staging_copy(tmp_path, monkeypatch):
    """The host store on the card: pinned staging sets, a gather's device
    blocks and ids equal to the checkpoint's experts, a layer's streamed
    stack equal to its experts, and one timed upload per staging round."""
    from smolvision_tpu_torch.config import detect_config
    from smolvision_tpu_torch.io.safetensors import MultiSafetensors
    from smolvision_tpu_torch.models.moe_offload import HostExpertStore

    model = _offload_model(tmp_path, monkeypatch)
    with MultiSafetensors(model) as reader:
        cfg = detect_config(model, reader)
        store = HostExpertStore(reader, cfg, "cuda")
        store.copy_events = []
        name = "thinker.model.layers.1.mlp.experts.{e}.{m}.weight"
        idx = np.array([[3, 1]])
        g, u, d, ids = store.gather(1, idx)
        assert all(b.is_pinned() for slot in store._slots for b in [*slot.bufs, slot.ids])
        for i, e in enumerate(idx[0]):
            assert torch.equal(g[0, i].cpu(), reader.get(name.format(e=e, m="gate_proj")))
            assert torch.equal(d[0, i].cpu(), reader.get(name.format(e=e, m="down_proj")))
        assert ids.tolist() == [3, 1]
        full = store.layer_full(0)
        for e in range(cfg.num_experts):
            assert torch.equal(full[1][e].cpu(), reader.get(
                f"thinker.model.layers.0.mlp.experts.{e}.up_proj.weight"))
        torch.cuda.synchronize()
        rounds = 1 + -(-cfg.num_experts // cfg.num_experts_per_tok)
        assert len(store.copy_events) == rounds
        assert [k for k, _, _ in store.copy_events] == ["gather"] + ["full"] * (rounds - 1)
        assert all(a.elapsed_time(b) >= 0 for _, a, b in store.copy_events)
        assert store.stats["gather_bytes"] == sum(t[0].numel() * t.element_size()
                                                  for t in (g, u, d))


def _key_values(keys: torch.Tensor) -> torch.Tensor:
    """The f32 values packed into head keys (argmax_matvec.pack_keys)."""
    ordered = (keys >> 32).to(torch.int32)
    bits = torch.where(ordered < 0, ordered ^ 0x7FFFFFFF, ordered)
    return bits.view(torch.float32)


@pytest.mark.cuda
def test_cuda_head_keys_with_an_offset_match_the_plain_packing():
    """A vocabulary-sharded head (parallel/mesh.py): K6 and K7 on both routes
    return keys whose index is offset by the shard's first row and whose
    value is the row's maximum; the MAX over two shards is the whole
    table's argmax, a tie across the boundary to the lower index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(5)
    V, H = 2 * 37_984, 1024
    before = dict(ffi.launch_counts)
    calls = {name: 0 for name in before}
    for R in (3, 16):
        w32 = torch.randn(V, H, device="cuda", generator=g) * 0.05
        h = torch.randn(R, H, device="cuda", generator=g)
        want = [(977 * r + 3) % V for r in range(R)]
        for r, v in enumerate(want):
            w32[v] = torch.sign(h[r]) * 0.5
        w32[V // 2] = w32[V // 2 - 1] = torch.sign(h[0]) * 0.6   # row 0: a boundary tie
        want[0] = V // 2 - 1
        qw = w32.abs().amax(-1) / 127.0
        q8 = torch.round(w32 / qw[:, None]).clamp(-127, 127).to(torch.int8)
        for w, scale in ((w32.to(torch.bfloat16), None), (q8, qw)):
            for route in ("cuda_core", "tensor_core"):
                parts = []
                for s in range(2):
                    rows = slice(s * V // 2, (s + 1) * V // 2)
                    ws, ss = w[rows].contiguous(), None if scale is None else scale[rows]
                    keys = tam.argmax_matvec(h, ws, ss, route=route, offset=rows.start)
                    calls[tam.launch_key(route, w.dtype)] += 1
                    plain = tam.argmax_matvec_plain(h, ws, ss, offset=rows.start)
                    assert torch.equal(tam.key_index(keys), tam.key_index(plain))
                    torch.testing.assert_close(_key_values(keys), _key_values(plain),
                                               rtol=1e-5, atol=1e-5)
                    parts.append(keys)
                best = tam.key_index(torch.stack(parts).max(dim=0).values)
                assert best.tolist() == want
    torch.cuda.synchronize()
    assert {k: ffi.launch_counts[k] - before[k] for k in before} == calls


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_on_one_card_equal_one_process(tmp_path, monkeypatch):
    """Two ranks sharing the card over gloo (tests/torch_mesh_worker.py):
    serving at (dp 2, tp 1) and batched segments at (1, 2) give the token
    rows of one process on the card, f32 weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels are built with nvcc for sm_90a)")
    from smolvision_tpu_torch.models import synthetic
    from smolvision_tpu_torch.runtime import batch_segments, serving
    from smolvision_tpu_torch.runtime.engine import Engine
    import importlib.util

    spec = importlib.util.spec_from_file_location(   # by path: a host may have another `tests`
        "torch_mesh_worker", os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py"))
    ranks_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks_mod)

    monkeypatch.setitem(synthetic.PRESETS, "card", CARD_PRESET)
    model = synthetic.build("card", str(tmp_path / "model"), seed=3)
    rng = np.random.default_rng(7)
    clips = [(rng.standard_normal(16000 * (1 + i % 3)) * 0.2).astype(np.float32)
             for i in range(6)]
    np.savez(tmp_path / "clips.npz", **{str(i): c for i, c in enumerate(clips)})
    common = {"model": model, "audio": str(tmp_path / "clips.npz"),
              "settings": {"max_tokens": 12}}
    cases = [dict(common, name="serve", kind="serve", mesh=[2, 1], slots=4),
             dict(common, name="segments", kind="segments", mesh=[1, 2])]
    from smolvision_tpu_torch.kernels import build

    build.build_all()   # once, before the ranks load the libraries
    procs = ranks_mod.start_ranks({"cases": cases, "device": "cuda:0"}, str(tmp_path))
    eng = Engine(model, param_dtype=torch.float32, kv_dtype=torch.float32, device="cuda")
    eng.max_tokens = 12
    want_serve = serving.decode_continuous(eng, clips, slots=4)
    want_segs = batch_segments.decode_segments_batched(eng, clips)
    ranks = ranks_mod.finish_ranks(procs, str(tmp_path), 600)
    for rank in ranks:
        assert rank["serve"]["rows"] == want_serve
        assert rank["segments"]["rows"] == want_segs


@pytest.mark.cuda
def test_cuda_device_log_mel_matches_host_mel():
    """The device front end on the card: TF32 off after resolve_device, the
    f16 upload on a side stream (the encode's stream waits on its event) and
    log_mel_batch against the host mel of the same f16-rounded audio."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from types import SimpleNamespace

    from smolvision_tpu_torch.device import resolve_device
    from smolvision_tpu_torch.ops import mel
    from smolvision_tpu_torch.runtime import batch_segments

    dev = resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    rng = np.random.default_rng(0)
    clips = [(rng.standard_normal(n) * 0.2).astype(np.float32) for n in (48077, 9000, 64050)]
    eng = SimpleNamespace(cfg=SimpleNamespace(enc_chunk_size=100), device=dev)
    for stream in (None, torch.cuda.Stream(dev)):
        up = batch_segments._upload_audio(eng, clips, stream)
        up.take()
        assert up.side == (stream is not None)
        got = mel.log_mel_batch(up.buf, torch.tensor(up.frames, device=dev), up.fcap)
        assert torch.equal(up.buf.cpu(), up.host)
        up.release()
        got = got.cpu().numpy()
        for b, (c, f) in enumerate(zip(clips, up.frames)):
            host = mel.log_mel(c.astype(np.float16).astype(np.float32))
            assert np.abs(got[b, :, :f] - host).max() < ATOL


@pytest.mark.cuda
def test_cuda_serving_wave_graph_replay_equals_eager(card_stream_engine, monkeypatch):
    """Seven clips through two serving slots: waves of 2, 2, 2 and 1.  The
    (Gcap 2, acap) wave graph's first wave runs eagerly, its second is
    captured in a decode chunk's shadow, its third replays; the token rows
    equal those of the same run with every wave step eager (no CUDA graph)
    and of the eager waves at a host start on fresh caches.  B5 counts one
    launch per layer per wave, replays included."""
    from smolvision_tpu_torch.runtime import decode_graph, serving

    eng = card_stream_engine
    eng.max_tokens = 12
    eng.set_force_language("English")
    rng = np.random.default_rng(9)
    clips = [(0.2 * np.sin(2 * np.pi * (150 + 30 * i) * np.arange(n) / 16000)
              + 0.02 * rng.standard_normal(n)).astype(np.float32)
             for i, n in enumerate((30000, 17000, 24000, 12800, 20000, 16000, 27000))]

    def run():
        eng.perf.reset()
        before = ffi.launch_counts["batched_cache_attention"]
        rows = serving.decode_continuous(eng, clips, slots=2)
        torch.cuda.synchronize()
        return rows, ffi.launch_counts["batched_cache_attention"] - before

    graph, b5 = run()
    waves = eng.perf.serving_waves
    assert [(w["rows"], w["how"], w["shadow"]) for w in waves] == [
        (2, "first", False), (2, "capture", True), (2, "replay", True), (1, "first", True)]
    assert eng.perf.prefill_captures == 1 and eng.perf.prefill_replays == 2
    assert b5 == eng.cfg.dec_layers * len(waves)
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "capture", _eager_capture)
        eager, _ = run()
    with monkeypatch.context() as m:
        m.setattr(serving, "wave_graphs", lambda engine, axis: False)
        host_start, _ = run()
        assert [w["how"] for w in eng.perf.serving_waves] == ["eager"] * 4
    assert graph == eager == host_start
