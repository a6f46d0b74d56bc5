#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smolvision_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card (Hopper: the
kernels are built for sm_90a).  Phases, each fatal on failure:

  1. device   - the card's name, count, and nvidia-smi's name / power limit;
  2. build    - nvcc builds the seven kernel libraries from
                smolvision_tpu_torch/kernels/csrc (seconds, ptxas report);
                then five fresh processes, one after another, run the build
                again with nvcc made unavailable: every library must come
                from the source-hash cache, and kernel K9 (probe_mm)
                launched from it must match torch.matmul (each reports its
                wrong outputs' count and positions);
  3. kernels  - each kernel against its plain torch version at the 0.6B
                shapes of the paths below plus edge cases (B1 at S 13 to
                208, under each split of a window's rows over blocks;
                all-pad windows and rows, empty cache, kv_min > 0, B5 at
                start 0 and > 0
                with per-row prompt_max / region_start, stale +-999 cache
                rows; B2 on a bf16 cache, B4 and B5 also at GQA group sizes
                that do not divide 64: G 7, Qwen2.5-Omni's decoder heads,
                and G 3; B3, which reads its position from device memory
                on a fixed grid, at starts that are not multiples of its
                blocks, with the position a host int and a device tensor,
                20 calls back to back, a CUDA-graph replay of them and one
                graph replayed at several positions; B2 on bf16 caches -- the tensor-core route,
                T 5 at start 300 as the --spec verify -- and on an f32
                cache, each with start and kv_valid host ints and device
                tensors, and one CUDA graph of B2 replayed at four starts
                (T 5, 128 and the main prefill's); the greedy heads K6 / K7 on both routes, the
                CUDA-core matvec and the tensor-core tile product, at R 1
                to 130, an exact tie across blocks, V not a multiple of any
                block or tile), then the sweep of R that sets the heads'
                crossover, B3's fixed grid at start 0 (its floor) and the
                sweep of B1's blocks per window, then timings against the plain
                version and one PyTorch library call (B1 at the windows of
                the offline, -S 20 and --serve 64 encode calls, B3 also at
                a 4096-row context, B5 also at --serve 64's admission
                wave, B2 also on an f32 cache beside SDPA and at the
                stream's delta shapes: start 300, T 128 and 256, checked
                at T 64-512, and at the --spec verify's T 5, start 300, each
                at a device start, against host ints in turns); K8 (read_all) over
                the lm_head gives the card's read bandwidth, against which
                each head kernel's time is set;
  4. main path- a seeded Qwen3-ASR-0.6B checkpoint (full width, random
                weights) transcribes a 20 s synthetic clip through
                `smolvision_tpu_torch.cli`; every kernel's launch count must
                rise by the expected amount; then the card's kernel path is
                held against the card's plain path (encoder output, prefill
                logits, greedy tokens);
  5. segments - `-S 20` on a 120 s clip through the CLI: batched encode
                (B1), batched fresh prefill (B4) and batched decode; then
                batched fresh- and delta-prefill logits, kernel path vs
                plain path, in bf16 and f32;
  6. serving  - 8 clips of 4-24 s through `--serve 4`: admission waves
                prefilled by kernel B5, slot reuse, TTFT percentiles;
  7. int8     - `--q8` (int8 decoder weights: head K7) and `--spec`
                (a CUDA graph of one speculative iteration per cache:
                SPEC_DRAFT int8 draft steps, B3 and K7 each, one verify
                forward through B2 at a device start and K6 at R
                SPEC_DRAFT + 1, the accept step; one host read per chunk)
                on the 20 s clip, `-S 20 --q8 --kv8` on the 120 s clip and
                `--serve 4 --kv8` on the 8 clips (int8 batched cache: the
                two-part attention, no B5); then the q8 kernel path against
                the plain path, and --spec tokens against plain greedy
                tokens on f32 weights (equal over the whole run) and on
                bf16 weights (equal up to the first near tie);
  8. wide     - `--serve 64` and `--serve 64 --q8` on 64 clips of 2-6 s:
                every greedy head is 64 rows wide and must take the
                tensor-core route (the CUDA-core head launches 0 times);
  9. stream   - `--stream` on a 60 s clip (30 chunks of 2 s, 8 s encoder
                windows, evicted past 4; each chunk re-encodes its partial
                tail through B1, prefills its delta through B2 at start =
                the reused rows, and decodes up to 32 tokens by replaying
                the decode loop's CUDA graph), bf16 and `--q8`; `--stream
                --enc-window-sec 2` on 20 s (B1 at S 26); `--stream --f32`
                on 16 s with the encoder window cache ON and then OFF (the
                chunks that encode one span either way must be equal in
                audio rows and raw tokens; past the first window, where the
                cache's per-span log-mel parts the audio rows, the parting
                is shown on the host and the tokens reported); `--stdin
                --stream` fed the 20 s clip through a pipe by a feeder
                process (it must reach EOF); `--stream --profile DIR`,
                which must leave a trace file.  Each stream's graph
                captures must be at most its caches (1 + growths), and its
                prefill graphs (a (cache, block rows) key's first prefill
                eager, its second captured, later ones replayed) at most
                its keys;
 10. multistream - `--stream -i` eight clips of 12-60 s (276 s): one
                round per 2 s chunk for all live sessions, B 8 rows
                compacted to 4, then 2, as sessions end; per round one
                batched encode of the sessions' new spans (B1), one batched
                delta prefill (B5, at start S > 0 with per-row prompt_max
                once every row reuses 64 rows or more; each round's block
                must be the one the reuse rule gives) and one batched
                decode (the head at R = B); against the same clips
                streamed solo one after another (realtime factors);
                `--q8 --kv8` (K7, the int8 batched cache through the
                two-part attention, no B5; compaction gathers a QuantKV);
                `--f32` on three clips against each clip's solo run (a
                parting must be at a near tie of the single-stream path:
                its top-2 gap under twice the largest f32 logit difference
                phase 4 measured between the kernel and plain paths); the
                threaded mode (SMOLVISION_BATCH_STREAMS=0) on two, whose
                texts must equal the batched and the solo runs'.  Decode
                graph captures at most the caches (allocation, growths,
                compactions) in every run; at least MSTREAM_MIN_DEEP_SHARE
                of the bf16 run's rounds at S > 0.  Then B5 at each round
                at S > 0 of the bf16 and --f32 runs (its B, S, W, pcap,
                kcap and per-row prompt_max, on the run's cache type)
                against its plain version, and timed once per distinct
                shape, each timing row's launches the run's B5 calls at
                that shape.
Each path that decodes greedily (--spec and multistream's bf16 run
included) runs twice, in turns: first with the decode loops' steps and
the prefills run eagerly on every replay, then as CUDA graphs (the path as
it ships, runtime/decode_graph.py).  The two runs' decoded chunks (tokens
and counts) must be equal, every captured graph must launch its step's
kernels once per replay (a decode step, a --spec iteration or a prefill),
and a loop reads the host once per chunk.  Each run has the launch counts set
to 0 just before it, and its counts must equal what its own bookkeeping
(engine.perf) says, each head under the launch key of the route its rows
take.  Decode ms per step and the device's idle share are measured for
graph and eager steps in turns (eager, graph, graph, eager) at each
path's batch and weights.

Prints the streams' and multistream runs' summaries, a `{"kernels": [...]}`
line, the nvidia-smi line, and as its last
line `{"ok": true, "device": {...}}`.  Without a card, or outside a
checkout, it exits non-zero and prints no result.  Imports nothing of JAX.
`--kernels-only` stops after phase 3 (the kernels line has no launches,
and no ok line follows).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"  # where the checks run; a CPU rehearsal of phases 3-4 sets "cpu"
SEED = 0
CLIP_SEC = 20.0
MAX_TOKENS = 64
SEGMENT_CLIP_SEC = 120.0     # phase 5: -S 20 on this clip
SEGMENT_SEC = 20
SERVE_CLIP_SEC = (24, 4, 16, 8, 20, 12, 6, 10)   # phase 6: --serve 4
SERVE_SLOTS = 4
SERVE_MAX_TOKENS = 32
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12,    # bf16 dense tensor-core rate
            "int8": 1979e12}       # int8 dense tensor-core rate
# Kernel vs plain: both compute in f32 from the same inputs and differ only in
# summation order (online softmax over tiles vs one reduction), ~1e-6
# relative on outputs of magnitude <~ 3; 1e-4 absolute leaves two orders of
# headroom and still catches any masking or indexing fault (those move
# outputs by O(0.1) or give NaN).
KERNEL_ATOL = 1e-4
# Kernel path vs plain path end to end, relative to the largest magnitude of
# the compared tensor (a wrong kernel gives O(1) differences):
#  * f32 weights and cache: the paths differ only in attention summation
#    order (~1e-6), which 18 + 28 layers of a random net amplify by far less
#    than 1000x;
#  * bf16 weights (the CLI's default): every matmul input is rounded to bf16
#    (2^-8 relative), so a 1e-6 attention difference flips single roundings
#    that the random net then amplifies (1.05% on prefill logits measured on
#    an H100, seed 0); 5% bounds that noise.
PATH_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}
# Greedy heads (K6 / K7) on random inputs: the kernel's choice may differ
# from torch.argmax only where two logits lie closer than the f32 summation
# order can move them (~1e-6 relative for 1024-term sums); the plain logit at
# the kernel's index must be within this share of the row's largest |logit|
# of the maximum.  On inputs with a planted winner the indices must be equal.
HEAD_RTOL = 1e-5
# probe_mm (K9) against torch.matmul: 256-term f32 sums of magnitude ~1 in
# another order
PROBE_MM_ATOL = 1e-4
# how each timed kernel computes, beside the "route" (CUDA C++ for all)
DESIGNS = {"window_attention": "tensor cores (f32 q/k/v: three mma.sync on hi / lo splits, "
                               "window resident)",
           "window_attention_segments": "as window_attention",
           "window_attention_wide": "as window_attention",
           "causal_cache_attention": "tensor cores (bf16 cache: mma.sync on a hi / lo split)",
           "causal_cache_attention_delta128": "as causal_cache_attention, at start > 0",
           "causal_cache_attention_delta256": "as causal_cache_attention, at start > 0",
           "batched_causal_attention": "tensor cores (f32 K/V: three mma.sync on hi / lo splits "
                                       "of both sides, 32-key tiles split once in shared memory)",
           "batched_cache_attention": "tensor cores (bf16 cache segments: two mma.sync per "
                                      "product; f32 cache and fresh K/V: three)",
           "batched_cache_attention_wide": "as batched_cache_attention",
           "decode_attention": "f32 CUDA cores, one launch of a fixed grid: a thread block "
                               "cluster of 8 blocks per KV head, its rows worked out from the "
                               "position it reads on the device, merging in distributed "
                               "shared memory",
           "decode_attention_long": "as decode_attention",
           "read_all": "CUDA cores",
           "probe_mm": "f32 CUDA cores, register-tiled (4 x 4 per lane), cp.async ring"}
# B1's timing rows: (row name, the shapes' key of its windows' kv_lens)
WINDOW_ROWS = (("window_attention", "window_lens"),                 # offline 20 s
               ("window_attention_segments", "seg_window_lens"),    # -S 20's encode call
               ("window_attention_wide", "wide_window_lens"))       # --serve 64's group
DECODE_LONG = (4096, 4095)    # (K, start) of B3's long-context row
# decode steps per profiled window (one chunk): the graph's windows are
# long enough that the chunk's own host read weighs as in a 64-step chunk;
# an eager window traces some 6000 host ops a step, so it is kept short
PROFILE_STEPS = {"eager": 8, "graph": 32}
# graph vs eager per path (run_path), printed as one line at the end
DECODE_RUNS = {}
BUILD_CACHE_CHECKS = 5        # fresh processes that load the libraries from the cache
HEAD_CHECK_ROWS = (1, 5, 6, 9, 11, 16, 33, 64, 130)   # R of the greedy-head checks
MAIN_HEADS = (16, 8, 128)     # (H, KH, D) of the 0.6B decoder: G 2
# (H, KH, D) at GQA group sizes that do not divide 64: G 7 (Qwen2.5-Omni's
# decoder heads, config.QWEN25_OMNI_7B) and G 3
GROUP_HEADS = ((28, 4, 128), (12, 4, 64))
HEAD_SWEEP_ROWS = (1, 2, 4, 5, 6, 8, 12, 16, 24, 32)  # R of the crossover sweep
SERVE_WIDE_SLOTS = 64         # the --serve width the JAX package documents
SERVE_WIDE_CLIPS = 64         # seeded clips of 2-6 s
SERVE_WIDE_MAX_TOKENS = 16
STREAM_CLIP_SEC = 60.0        # phase 9: --stream, bf16 and --q8 (30 chunks)
STREAM_WINDOW_CLIP_SEC = 20.0  # --stream --enc-window-sec 2; --stdin --stream
STREAM_ON_OFF_CLIP_SEC = 16.0  # --stream --f32, encoder cache ON / OFF (no eviction)
STREAM_PROFILE_CLIP_SEC = 4.0  # --stream --profile DIR
LIVE_FEED_BYTES = 32000       # the live feeder writes 1 s of s16 audio ...
LIVE_FEED_PAUSE_S = 0.05      # ... then pauses this long
LIVE_TIMEOUT_S = 300          # a live run that has not reached EOF by then is a fault
# B2's timing rows at the stream's delta prefill, whose blocks are 128 and
# 256 rows at 8 s windows (64 at 2 s): (row, T, start, kv_valid)
B2_DELTA_ROWS = (("causal_cache_attention_delta128", 128, 300, 421),
                 ("causal_cache_attention_delta256", 256, 300, 549))
# B2's timing row at the --spec verify: SPEC_DRAFT + 1 rows at a device start
B2_VERIFY_ROW = ("causal_cache_attention_verify", 5, 300, 305)
# per stream run (phase 9), printed as one line at the end
STREAM_RUNS = {}
# phase 10: multistream, one session per clip (seconds), B 8 compacted to 4, then 2
MSTREAM_CLIP_SEC = (12, 16, 20, 24, 36, 48, 60, 60)
MSTREAM_F32_CLIPS = 3         # --stream --f32 on the first three clips, against solo
MSTREAM_THREADED_CLIPS = 2    # SMOLVISION_BATCH_STREAMS=0 on the first two
# B5's phase-3 check at a synthetic multistream round: (B, W, S, pcap, kcap,
# per-row prompt_max): a W 128 block at S 256 of a pcap 768 cache.  Its
# checks and timings at the rounds the path runs follow phase 10
# (`mstream_b5_table`)
MSTREAM_B5 = (8, 128, 256, 768, 832, [600 + 14 * b for b in range(8)])
# the least share of the bf16 multistream run's rounds at S > 0 (B5's cache
# half); 3 of 30 rounds on the eight clips (PERF.md)
MSTREAM_MIN_DEEP_SHARE = 0.05
# the largest logit difference between the card's kernel and plain paths on
# f32 weights (phase 4: offline, fresh, served and delta prefill), set there;
# a --f32 multistream session may part from its solo run only where the solo
# path's top-2 gap is under twice this
F32_LOGIT_DIFF = None
# per multistream run (phase 10), printed as one line at the end
MSTREAM_RUNS = {}
CARD_LINE = "not read"        # nvidia-smi's name and power limit, set in phase 1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.monotonic()


def since(what: str) -> None:
    log(f"{what} done, {time.monotonic() - _T0:.1f} s since the start")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """CUDA-event time per call of `iters` calls issued from Python.  For a
    call shorter than its host-side launch cost this measures the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """CUDA-event time per call of one CUDA-graph replay of `iters` calls:
    the device's time for back-to-back calls, without the Python launch
    gaps that dominate `eager_ms` for calls of a few microseconds."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, op_dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[op_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def check_close(name: str, got, want, atol: float = KERNEL_ATOL) -> float:
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if err > atol:
        fail(f"{name}: max_abs_err {err:.3g} > {atol:g}")
    return err


def window_case(W, lens, S=104, H=14, D=64, garbage=False):
    import torch

    g = torch.Generator(device=DEV).manual_seed(W * 1000 + sum(lens))
    q, k, v = (torch.randn(W, S, H, D, device=DEV, generator=g) for _ in range(3))
    if garbage:  # pad keys hold junk that must not leak in
        for w, n in enumerate(lens):
            k[w, n:] = 999.0
            v[w, n:] = -999.0
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=DEV)


def cache_case(T, K, start, kv_valid, H=16, KH=8, D=128, seed=0, dtype="bfloat16"):
    """q block at rows start+t; a bf16 (or f32) cache holding it, with +-999
    in every row at or past kv_valid (the pad rows prefill writes, and stale
    rows)."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(T, H, D, device=DEV, generator=g)
    k = torch.randn(K, KH, D, device=DEV, generator=g).to(getattr(torch, dtype))
    v = torch.randn(K, KH, D, device=DEV, generator=g).to(getattr(torch, dtype))
    k[kv_valid:] = 999.0
    v[kv_valid:] = -999.0
    return q, k, v


def decode_case(K, start, H=16, KH=8, D=128, seed=0):
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed + K + start)
    q = torch.randn(H, D, device=DEV, generator=g)
    k_new = torch.randn(KH, D, device=DEV, generator=g)
    v_new = torch.randn(KH, D, device=DEV, generator=g)
    k = torch.randn(K, KH, D, device=DEV, generator=g).to(torch.bfloat16)
    v = torch.randn(K, KH, D, device=DEV, generator=g).to(torch.bfloat16)
    k[start:] = 999.0
    v[start:] = -999.0
    return q, k_new, v_new, k, v


def batched_case(B, T, H=16, KH=8, D=128, seed=0):
    """q [B, T, H, D] and fresh k / v [B, T, KH, D], f32."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed + B * 1000 + T)
    return (torch.randn(B, T, H, D, device=DEV, generator=g),
            torch.randn(B, T, KH, D, device=DEV, generator=g),
            torch.randn(B, T, KH, D, device=DEV, generator=g))


def batched_cache(B, K, start, kv_min, prompt_max=None, region_start=None, KH=8, D=128,
                  dtype="bfloat16", seed=0):
    """k / v [B, KH, K, D] views of an [L=1, 2, B, KH, K, D] batched cache,
    with +-999 in every column the window of row b leaves out."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed + K + start)
    kv = torch.randn(1, 2, B, KH, K, D, device=DEV, generator=g).to(getattr(torch, dtype))
    cols = torch.arange(K, device=DEV)
    for b in range(B):
        live = (cols >= kv_min[b]) & (cols < start)
        if prompt_max is not None:
            rs = region_start if isinstance(region_start, int) else region_start[b]
            live &= (cols < prompt_max[b]) | (cols >= rs)
        kv[0, 0, b][:, ~live] = 999.0
        kv[0, 1, b][:, ~live] = -999.0
    return kv[0, 0], kv[0, 1]


def decode_row(K: int, start: int):
    """B3's timing inputs at (K, start): (kernel, plain, SDPA, bound).  The
    kernel reads start from a device tensor, as the decode step passes it.
    SDPA gets the same rows in bf16 with the fresh row written into the
    cache at `start`; the bound reads the live bf16 rows once, q, the fresh
    row and the output in f32."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    q, kn, vn, k, v = decode_case(K, start)
    H, D = q.shape
    KH = kn.shape[0]
    nbytes = 4 * (2 * q.numel() + 2 * kn.numel()) + 2 * 2 * start * KH * D
    flops = 4 * H * D * (start + 1)
    at = torch.tensor([start], dtype=torch.int32, device=DEV)   # the decode step's position
    k[start] = kn.to(torch.bfloat16)
    v[start] = vn.to(torch.bfloat16)
    qb = q.to(torch.bfloat16)[None, :, None, :]
    kb, vb = (x[: start + 1].permute(1, 0, 2)[None] for x in (k, v))
    return (lambda: fa.decode_flash_attention(q, kn, vn, k, v, at),
            lambda: fa.decode_attention_plain(q, kn, vn, k, v, start, 0),
            lambda: F.scaled_dot_product_attention(qb, kb, vb, enable_gqa=True),
            bound(nbytes, flops, "bfloat16"))


def kernel_of(name: str) -> str:
    """The launch key of a timing row: its kernel's name without the suffix
    of the shape it was timed at."""
    for suffix in ("_long", "_wide", "_segments", "_delta128", "_delta256", "_verify"):
        name = name.removesuffix(suffix)
    return name.split("_mstream")[0]


def window_row(lens, S=104, H=14, D=64):
    """B1's timing inputs at windows `lens`: (kernel, plain, SDPA, bound,
    f32 CUDA-core bound).  The bound reads q and writes the output at every
    row and reads the valid K / V rows once; its operations are the valid
    keys' products (SDPA gets the same f32 rows and mask)."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    q, k, v, lens_t = window_case(len(lens), lens, S=S, H=H, D=D)
    mask = (torch.arange(S, device=DEV)[None, :] < lens_t[:, None])[:, None, None, :]
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    nbytes = 4 * (2 * q.numel() + 2 * sum(lens) * H * D)
    flops = 4 * S * sum(lens) * H * D
    return (lambda: fa.window_flash_attention(q, k, v, lens_t),
            lambda: fa.window_attention_plain(q, k, v, lens_t),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            bound(nbytes, flops, "bfloat16"), bound(nbytes, flops, "float32"))


def window_splits(S: int):
    """The WINDOW_ROW_BLOCKS values a correctness case runs under: the
    plan's own pick (None), then each split it could make."""
    from smolvision_tpu_torch.kernels import flash_attention as fa

    return (None,) if S > fa.WINDOW_BLOCK_ROWS else (None, 1, 2)


@contextlib.contextmanager
def window_split(n):
    """B1 with fa.WINDOW_ROW_BLOCKS forced to n (None: the plan picks)."""
    from smolvision_tpu_torch.kernels import flash_attention as fa

    kept = fa.WINDOW_ROW_BLOCKS
    fa.WINDOW_ROW_BLOCKS = n
    try:
        yield
    finally:
        fa.WINDOW_ROW_BLOCKS = kept


def window_split_sweep(shapes) -> dict:
    """B1 at each WINDOW_ROWS shape with a window's rows in one block and
    split over two: the time behind `window_row_blocks`'s choice."""
    import torch

    from smolvision_tpu_torch.kernels import flash_attention as fa

    out = {}
    for n in (1, 2):
        with window_split(n):
            out[n] = [time_ms(window_row(shapes[key])[0]) for _, key in WINDOW_ROWS]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["plan"] = [fa.window_row_blocks(len(shapes[key]), 104, 14, sms) for _, key in WINDOW_ROWS]
    return out


def cache_row(T: int, K: int, start: int, valid: int, dtype: str = "bfloat16",
              host_ints: bool = False):
    """B2's timing inputs: a block of T query rows at cache rows start.. of
    a K-row cache of `dtype` holding `valid` rows: (kernel, plain, SDPA,
    bound).  The kernel reads start and kv_valid from device tensors, as
    the prefill graphs and the --spec verify pass them (`host_ints`: host
    ints, filled in on the device per call).  SDPA gets q in the cache's
    type and the same causal mask over the valid rows; the bound reads q
    and writes the output in f32, reads the valid cache rows once, and
    counts the products the mask keeps, at the tensor cores' bf16 rate."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    q, k, v = cache_case(T, K, start, valid, dtype=dtype)
    H, D = q.shape[1:]
    KH = k.shape[1]
    nbytes = 4 * 2 * q.numel() + k.element_size() * 2 * valid * KH * D
    flops = 4 * H * D * sum(min(start + t + 1, valid) for t in range(T))
    qh = q.to(k.dtype).permute(1, 0, 2)[None]
    kh, vh = (x[:valid].permute(1, 0, 2)[None] for x in (k, v))
    mask = (torch.arange(valid, device=DEV)[None, :]
            <= start + torch.arange(T, device=DEV)[:, None])
    at, n = start, valid
    if not host_ints:
        at = torch.tensor([start], dtype=torch.int64, device=DEV)
        n = at + (valid - start)
    return (lambda: fa.causal_cache_flash_attention(q, k, v, at, n),
            lambda: fa.causal_cache_attention_plain(q, k, v, start, valid),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, enable_gqa=True),
            bound(nbytes, flops, "bfloat16"))


def b2_f32_timings(shapes) -> str:
    """B2 on an f32 cache (the --f32 engine's prefill) at the main path's
    prefill shape and at the stream's delta shapes: kernel (turns), plain,
    SDPA on the same f32 rows and mask, and its bound (`cache_row`)."""
    out = []
    for name, T, start, valid in (("main", shapes["prefill_T"], 0, shapes["prompt_len"]),
                                  *B2_DELTA_ROWS):
        K = shapes["kv_cap"] if name == "main" else 1024
        kern, plain, lib, (bound_ms, bound_by) = cache_row(T, K, start, valid, "float32")
        out.append(f"{name} (T {T}, start {start}, valid {valid}): kernel "
                   f"{time_ms(kern):.4f}/{time_ms(kern):.4f} ms, plain {time_ms(plain):.4f} ms, "
                   f"library (SDPA, f32) {time_ms(lib):.4f} ms, "
                   f"bound {bound_ms:.4f} ms ({bound_by})")
    return "; ".join(out)


def phase_kernels(shapes):
    """Correctness sweep, then timings at the main-path shapes."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import ffi
    from smolvision_tpu_torch.kernels import flash_attention as fa

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=DEV)

    errs = {name: 0.0 for name in ffi.launch_counts}

    # B1: the paths' windows (offline W 4, -S 20's one encode call, --serve
    # 64's encode group), S 13, 26 and 100 (--enc-window-sec 1 and 2,
    # Qwen2.5-Omni's) and S 208 (above one block's rows: the query-tiled
    # route), all-pad windows exactly 0, +-999 junk in the pad keys; each
    # S <= WINDOW_BLOCK_ROWS case under every split of a window's rows
    cases = [(104, [104, 0], False), (104, shapes["window_lens"], False),
             (104, [104, 77, 1, 0], True), (104, shapes["seg_window_lens"], True),
             (104, shapes["wide_window_lens"], True), (13, [13, 1, 0, 7], True),
             (26, [26, 26, 9, 0], True),
             (100, [100, 64, 17, 0], True), (208, [208, 130, 0], True)]
    for S, lens, garbage in cases:
        q, k, v, lens_t = window_case(len(lens), lens, S=S, garbage=garbage)
        want = fa.window_attention_plain(q, k, v, lens_t)
        for split in window_splits(S):
            with window_split(split):
                got = fa.window_flash_attention(q, k, v, lens_t)
            err = check_close(f"B1 S={S} W={len(lens)} lens={lens[:8]} split={split}", got, want)
            for w in (w for w, n in enumerate(lens) if n == 0):
                if float(got[w].abs().max()) != 0.0:
                    fail(f"B1 S={S} W={len(lens)} split={split}: all-pad window {w} is not "
                         f"exactly 0")
            errs["window_attention"] = max(errs["window_attention"], err)

    # B2: T 256 / 512, K 1024, start 0 and > 0, kv_min 0 and > 0, stale rows,
    # T 5 at start 300 (the --spec verify); bf16 caches (two products) and
    # one f32 cache (three); then each of GROUP_HEADS, whose blocks
    # hold floor(64 / G) queries of each head and dead rows past G times
    # that, at T that are not multiples of it
    # (T, start, kv_valid, kv_min, cache, (H, KH, D)); kv_valid < start + T
    # leaves pad rows
    cases = [(256, 0, 200, 0, "bfloat16"), (512, 0, shapes["prompt_len"], 0, "bfloat16"),
             (512, 300, 700, 0, "bfloat16"), (256, 100, 330, 37, "bfloat16"),
             (5, 300, 305, 0, "bfloat16"), (5, 300, 305, 17, "bfloat16"),
             (512, 0, shapes["prompt_len"], 0, "float32")]
    # the stream's KV-reuse prefill: a delta block after ~300 reused rows
    cases += [(T, 300, 300 + T - 7, 0, dtype) for T in (64, 128, 256, 512)
              for dtype in ("bfloat16", "float32")]
    cases = [c + (MAIN_HEADS,) for c in cases]
    for heads in GROUP_HEADS:
        cases += [(100, 0, 97, 0, "bfloat16", heads), (256, 100, 330, 37, "bfloat16", heads),
                  (5, 300, 305, 17, "bfloat16", heads), (100, 0, 97, 0, "float32", heads)]
    # each with start and kv_valid host ints, then int32 / int64 device
    # tensors (the prefill graphs' and the --spec verify's form)
    for i, (T, start, kv_valid, kv_min, dtype, (H, KH, D)) in enumerate(cases):
        q, k, v = cache_case(T, 1024, start, kv_valid, H, KH, D, dtype=dtype)
        want = fa.causal_cache_attention_plain(q, k, v, start, kv_valid, kv_min)
        dev_start = torch.tensor([start], dtype=(torch.int32, torch.int64)[i % 2], device=DEV)
        for form, at, n in (("host", start, kv_valid),
                            ("device", dev_start, dev_start + (kv_valid - start))):
            got = fa.causal_cache_flash_attention(q, k, v, at, n, kv_min=kv_min)
            err = check_close(f"B2 T={T} start={start} valid={kv_valid} kv_min={kv_min} {dtype} "
                              f"H={H} KH={KH} D={D} {form} start", got, want)
            errs["causal_cache_attention"] = max(errs["causal_cache_attention"], err)
    # one CUDA graph of B2 at a device start, captured at start 300 and
    # replayed at other starts by changing its two tensors alone, at the
    # verify's T 5, a stream delta's T 128 and the main prefill's T; +-999
    # in every row past each replay's valid rows
    if DEV == "cuda":
        for T in (5, 128, shapes["prefill_T"]):
            q, k, v = cache_case(T, 1024, 300, 1024, dtype="bfloat16")
            clean = (k.clone(), v.clone())
            at = torch.tensor([300], dtype=torch.int32, device=DEV)
            n = at + T
            fa.causal_cache_flash_attention(q, k, v, at, n)   # warm-up outside the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fa.causal_cache_flash_attention(q, k, v, at, n)
            for start, valid in ((300, 300 + T), (0, T - 1), (37, 37 + T), (1024 - T, 1024 - 2)):
                k.copy_(clean[0])
                v.copy_(clean[1])
                k[valid:], v[valid:] = 999.0, -999.0
                at.fill_(start)
                n.fill_(valid)
                out.fill_(float("nan"))
                graph.replay()
                torch.cuda.synchronize()
                want = fa.causal_cache_attention_plain(q, k, v, start, valid)
                errs["causal_cache_attention"] = max(
                    errs["causal_cache_attention"],
                    check_close(f"B2 graph T={T} replayed at start {start}", out, want))
            del graph

    # B3: K 1024 / 4096, start in {0, 1, 5, 37, 300, the main path's, K-1},
    # kv_min 0 and > 0 (fewer live rows than the grid's 8 blocks, and
    # starts that are not multiples of 8), the position a host int and a
    # device tensor; then 20 calls back to back and one CUDA-graph replay
    # of them, which must give the same output each time (the cluster
    # merge leaves no state behind), and the graph replayed at other
    # positions by changing its position tensor alone
    def at(x):
        return torch.tensor([x], dtype=torch.int32, device=DEV)

    for K in (1024, 4096):
        for start in (0, 1, 5, 37, 300, shapes["decode_pos"], K - 1):
            for kv_min in {0, min(17, start)}:
                q, kn, vn, k, v = decode_case(K, start)
                want = fa.decode_attention_plain(q, kn, vn, k, v, start, kv_min)
                for pos, lo in ((start, kv_min), (at(start), at(kv_min))):
                    got = fa.decode_flash_attention(q, kn, vn, k, v, pos, lo)
                    err = check_close(f"B3 K={K} start={start} kv_min={kv_min} "
                                      f"{type(pos).__name__} position", got, want)
                    errs["decode_attention"] = max(errs["decode_attention"], err)
    q, kn, vn, k, v = decode_case(DECODE_LONG[0], shapes["decode_pos"])
    pos = at(shapes["decode_pos"])
    want = fa.decode_attention_plain(q, kn, vn, k, v, shapes["decode_pos"], 0)
    outs = [fa.decode_flash_attention(q, kn, vn, k, v, pos) for _ in range(20)]
    if DEV == "cuda":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = [fa.decode_flash_attention(q, kn, vn, k, v, pos) for _ in range(20)]
        for o in replayed:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        outs += replayed
    for i, o in enumerate(outs):
        errs["decode_attention"] = max(errs["decode_attention"],
                                       check_close(f"B3 back-to-back call {i}", o, want))
    if DEV == "cuda":
        # rows past decode_pos hold +-999: the grid's rows must follow the
        # position the graph reads, not the one it was captured at
        for start in (0, 1, shapes["decode_pos"] // 2, shapes["decode_pos"]):
            pos.fill_(start)
            graph.replay()
            torch.cuda.synchronize()
            want = fa.decode_attention_plain(q, kn, vn, k, v, start, 0)
            for o in replayed:
                errs["decode_attention"] = max(
                    errs["decode_attention"],
                    check_close(f"B3 graph replayed at start {start}", o, want))
        del graph

    # B4: the -S run's batch and left pads; an all-pad row, kv_min > 0 in
    # every row, and a T that is not a multiple of the block's queries per
    # head; then each of GROUP_HEADS
    B4, T4, pads4 = shapes["seg_B"], shapes["seg_T"], shapes["seg_pads"]
    cases = [(B4, T4, pads4, MAIN_HEADS), (3, T4, [T4, 1, 200], MAIN_HEADS),
             (2, 100, [7, 99], MAIN_HEADS)]
    for heads in GROUP_HEADS:
        cases += [(3, 100, [0, 100, 37], heads), (2, T4, [5, 63], heads)]
    for B, T, kv_min, (H, KH, D) in cases:
        q, k, v = batched_case(B, T, H, KH, D)
        got = fa.batched_causal_flash_attention(q, k, v, ints(kv_min))
        err = check_close(f"B4 B={B} T={T} kv_min={kv_min} H={H} KH={KH} D={D}", got,
                          fa.batched_causal_attention_plain(q, k, v, ints(kv_min)))
        for b, lo in enumerate(kv_min):
            if lo and float(got[b, :lo].abs().max()) != 0.0:
                fail(f"B4 B={B} T={T} H={H}: left-pad rows of row {b} are not exactly 0")
        errs["batched_causal_attention"] = max(errs["batched_causal_attention"], err)

    # B5: serving's group prefill (start 0, per-row prompt lengths), then
    # the cache half at start > 0 with per-row prompt_max / region_start,
    # kv_min > 0, a row whose cache window is empty and whose first fresh
    # rows attend nothing (exactly 0), bf16 and f32 caches; then each of
    # GROUP_HEADS; then --serve 64's admission wave
    G5, T5, lens5 = shapes["serve_G"], shapes["serve_T"], shapes["serve_lens"]
    cases = [(G5, T5, T5, 0, [0] * G5, lens5, 1 << 30, "bfloat16", MAIN_HEADS)]
    for dtype in ("bfloat16", "float32"):
        cases += [(4, 64, 1024, 448, [0, 17, 0, 500], [300, 120, 448, 200],
                   [400, 300, 0, 64], dtype, MAIN_HEADS),
                  (3, 128, 768, 320, [5, 0, 0], [100, 7, 320], 256, dtype, MAIN_HEADS),
                  (2, 64, 512, 200, [0, 9], None, None, dtype, MAIN_HEADS)]
        for heads in GROUP_HEADS:
            cases += [(3, 100, 512, 0, [0, 0, 0], [100, 60, 1], 1 << 30, dtype, heads),
                      (4, 100, 1024, 448, [0, 17, 0, 500], [300, 120, 448, 200],
                       [400, 300, 0, 64], dtype, heads),
                      (3, 100, 768, 320, [5, 0, 0], [100, 7, 320], 256, dtype, heads)]
    GW, TW, lensw = shapes["wide_G"], shapes["wide_T"], shapes["wide_lens"]
    cases.append((GW, TW, TW, 0, [0] * GW, lensw, 1 << 30, "bfloat16", MAIN_HEADS))
    # a synthetic multistream round: the cache half at S 256 (bf16 and f32
    # caches) and the full-cap block at S 0 (the rounds phase 10 runs are
    # checked after it, `mstream_b5_table`)
    Bm, Wm, Sm, pcap_m, kcap_m, pm_m = MSTREAM_B5
    for S, W, dtype in ((Sm, Wm, "bfloat16"), (Sm, Wm, "float32"), (0, pcap_m, "bfloat16")):
        cases.append((Bm, W, kcap_m, S, [0] * Bm, pm_m, pcap_m, dtype, MAIN_HEADS))
    for B, T, K, start, kv_min, pm, rs, dtype, (H, KH, D) in cases:
        q, kn, vn = batched_case(B, T, H, KH, D)
        kc, vc = batched_cache(B, K, start, kv_min, pm, rs, KH, D, dtype=dtype)
        args = (q, kn, vn, kc, vc, start, ints(kv_min), None if pm is None else ints(pm),
                rs if rs is None or isinstance(rs, int) else ints(rs))
        got = fa.batched_cache_flash_attention(*args)
        err = check_close(f"B5 B={B} T={T} K={K} start={start} {dtype} H={H} KH={KH} D={D}",
                          got, fa.batched_cache_attention_plain(*args))
        for b, lo in enumerate(kv_min):
            if lo > start and float(got[b, :lo - start].abs().max()) != 0.0:
                fail(f"B5 B={B} T={T} start={start} H={H}: rows of row {b} with no key are "
                     f"not exactly 0")
        errs["batched_cache_attention"] = max(errs["batched_cache_attention"], err)
    log(f"kernels vs plain: max_abs_err {json.dumps(errs)} (tolerance {KERNEL_ATOL:g})")

    rows = []
    # --- B1 at the windows of the offline path, of -S 20's encode call and of
    # --serve 64's encode group; the bound is the tensor cores' (bf16
    # operands, as B2's); the f32 CUDA-core bound of the earlier design is
    # logged beside it
    f32_bounds = {}
    for name, key in WINDOW_ROWS:
        row = window_row(shapes[key])
        rows.append((name, "smolvision_tpu_torch/kernels/csrc/window_attention.cu",
                     "smolvision_tpu/kernels/flash_attention.py:60", *row[:4]))
        f32_bounds[name] = row[4]

    # --- B2 at the main-path shape (prefill from an empty cache), then at
    # the stream's delta prefill (start > 0 on a 1024-row cache)
    K = shapes["kv_cap"]
    b2_rows = (("causal_cache_attention", shapes["prefill_T"], 0, shapes["prompt_len"]),
               *B2_DELTA_ROWS, B2_VERIFY_ROW)
    for name, T, start, valid in b2_rows:
        rows.append((name, "smolvision_tpu_torch/kernels/csrc/causal_cache_attention.cu",
                     "smolvision_tpu/kernels/flash_attention.py:491",
                     *cache_row(T, K if start == 0 else 1024, start, valid)))
    b2_forms = {}   # in turns: device, host, host, device
    for name, T, start, valid in b2_rows:
        K2 = K if start == 0 else 1024
        kern = {h: cache_row(T, K2, start, valid, host_ints=h)[0] for h in (False, True)}
        turns = [(h, time_ms(kern[h])) for h in (False, True, True, False)]
        b2_forms[name] = {form: [ms for h, ms in turns if h == host]
                          for form, host in (("device", False), ("host", True))}

    # --- B3 at a mid-decode shape of the main path, and at a long context
    for name, K3, start in (("decode_attention", K, shapes["decode_pos"]),
                            ("decode_attention_long", *DECODE_LONG)):
        rows.append((name, "smolvision_tpu_torch/kernels/csrc/decode_attention.cu",
                     "smolvision_tpu/kernels/flash_attention.py:184",
                     *decode_row(K3, start)))

    # --- B4 at the -S run's shape (fresh prefill of one length group); the
    # bound is the tensor cores' (bf16 operands, as B2's); the f32 CUDA-core
    # bound of the earlier design is logged beside it
    q4, k4, v4 = batched_case(B4, T4)
    km4 = ints(pads4)
    H4, D4 = q4.shape[2:]
    attended = sum(max(t + 1 - lo, 0) for lo in pads4 for t in range(T4))
    nbytes = 4 * (2 * q4.numel() + 2 * k4.numel())
    flops = 4 * H4 * D4 * attended
    ar = torch.arange(T4, device=DEV)
    mask4 = ((ar[None, :] <= ar[:, None])[None] & (ar[None, None, :] >= km4[:, None, None]))
    q4h, k4h, v4h = (x.transpose(1, 2) for x in (q4, k4, v4))
    rows.append(("batched_causal_attention",
                 "smolvision_tpu_torch/kernels/csrc/batched_causal_attention.cu",
                 "smolvision_tpu/kernels/flash_attention.py:286",
                 lambda: fa.batched_causal_flash_attention(q4, k4, v4, km4),
                 lambda: fa.batched_causal_attention_plain(q4, k4, v4, km4),
                 lambda: F.scaled_dot_product_attention(q4h, k4h, v4h, attn_mask=mask4[:, None],
                                                        enable_gqa=True),
                 bound(nbytes, flops, "bfloat16")))
    f32_bounds["batched_causal_attention"] = bound(nbytes, flops, "float32")

    # --- B5 at serving's group prefill (start 0: the cache is not read),
    # at --serve 4's wave and at --serve 64's (one wave of 64 clips)
    for name, (G, T, lens) in (("batched_cache_attention", (G5, T5, lens5)),
                               ("batched_cache_attention_wide", (GW, TW, lensw))):
        q5, kn5, vn5 = batched_case(G, T)
        kc5, vc5 = batched_cache(G, T, 0, [0] * G)
        km5, pm5 = ints([0] * G), ints(lens)
        attended = G * T * (T + 1) // 2
        nbytes = 4 * (2 * q5.numel() + 2 * kn5.numel())
        flops = 4 * q5.shape[2] * q5.shape[3] * attended
        mask5 = (torch.arange(T, device=DEV)[None, :] <= torch.arange(T, device=DEV)[:, None])
        q5h, k5h, v5h = (x.transpose(1, 2) for x in (q5, kn5, vn5))
        args = (q5, kn5, vn5, kc5, vc5, 0, km5, pm5, 1 << 30)
        rows.append((name, "smolvision_tpu_torch/kernels/csrc/batched_cache_attention.cu",
                     "smolvision_tpu/kernels/flash_attention.py:412",
                     lambda a=args: fa.batched_cache_flash_attention(*a),
                     lambda a=args: fa.batched_cache_attention_plain(*a),
                     lambda q=q5h, k=k5h, v=v5h, m=mask5:
                         F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=True),
                     bound(nbytes, flops, "bfloat16")))
        f32_bounds[name] = bound(nbytes, flops, "float32")

    log(f"  B3 on its fixed grid with no live row (the fresh row alone: the launch, the "
        f"cluster barriers and the merge, the kernel's floor): "
        f"{time_ms(decode_row(K, 0)[0]):.4f} ms")
    log(f"  window split sweep (blocks per (window, head): ms at "
        f"{' / '.join(name for name, _ in WINDOW_ROWS)}; the plan's pick): "
        f"{json.dumps(window_split_sweep(shapes))}")
    log(f"  B2 on an f32 cache: {b2_f32_timings(shapes)}")
    log(f"  B2 with start / kv_valid device tensors against host ints (ms, in turns "
        f"device, host, host, device): {json.dumps(b2_forms)}")

    return timed_table(rows, errs, f32_bounds)


def timed_table(rows, errs: dict, f32_bounds: dict) -> list:
    """The kernels line's entries of timing rows (name, source, replaces,
    kernel, plain, library, bound): the kernel and the plain version in
    turns, the library call, each row's max_abs_err (`errs` by row name,
    else by its kernel)."""
    table = []
    for name, source, replaces, kern, plain, lib, (bound_ms, bound_by) in rows:
        # turns: plain, kernel, kernel, plain (noise shows as disagreement)
        p1, k1, k2_, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
        table.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": errs[name] if name in errs else errs[kernel_of(name)],
            "ms": min(k1, k2_), "plain_ms": min(p1, p2),
            "library_ms": time_ms(lib), "bound_ms": bound_ms, "bound_by": bound_by,
            "design": DESIGNS.get(name) or DESIGNS.get(kernel_of(name), "f32 CUDA cores"),
        })
        f32 = (f", f32 CUDA-core bound {f32_bounds[name][0]:.4f} ms ({f32_bounds[name][1]})"
               if name in f32_bounds else "")
        log(f"  {name}: kernel {k1:.4f}/{k2_:.4f} ms (eager {eager_ms(kern):.4f} ms), "
            f"plain {p1:.4f}/{p2:.4f} ms, library {table[-1]['library_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}){f32}")
    return table


# ---------------------------------------------------------------------------
# phase 3, continued: the greedy heads (K6 / K7) and the probes (K8 / K9)
# ---------------------------------------------------------------------------

def head_case(V: int, H: int, R: int, kind: str, seed: int, planted: bool = False):
    """h [R, H] f32 and an lm_head [V, H] of `kind` (bfloat16 / float32 /
    int8 with per-row scales, quantized as ops/quant.quantize_weight does).
    With `planted`, row r of h has a clear winner at (7919 r + 11) % V (a
    weight row aligned with h_r); returns (h, w, scale, winners or None)."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    w = torch.randn(V, H, device=DEV, generator=g) * 0.05
    h = torch.randn(R, H, device=DEV, generator=g)
    winners = None
    if planted:
        winners = [(7919 * r + 11) % V for r in range(R)]
        for r, v in enumerate(winners):
            w[v] = torch.sign(h[r]) * 0.5
    scale = None
    if kind == "int8":
        scale = torch.clamp(w.abs().amax(-1) / 127.0, min=1e-12)
        w = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    else:
        w = w.to(getattr(torch, kind))
    return h, w, scale, winners


def check_head(name: str, h, w, scale=None, winners=None, route=None) -> float:
    """K6 / K7 against the plain version, on `route` (by default the one
    head_route picks): equal indices where a winner is planted; elsewhere
    the plain logit at the kernel's index within HEAD_RTOL of the row's
    largest |logit| of the maximum.  Returns the largest shortfall (plain
    max logit - plain logit at the kernel's index)."""
    import torch

    from smolvision_tpu_torch.kernels import argmax_matvec as am

    got = am.argmax_matvec(h, w, scale, route=route)
    logits = am.logits_plain(h, w, scale)
    want = torch.argmax(logits, dim=-1)
    if winners is not None and not (got.tolist() == winners == want.tolist()):
        fail(f"{name}: kernel {got.tolist()} / plain {want.tolist()} != planted {winners}")
    short = logits.amax(-1) - logits.gather(1, got.long()[:, None])[:, 0]
    tol = HEAD_RTOL * logits.abs().amax(-1)
    if not bool((short <= tol).all()):
        fail(f"{name}: the kernel's choice is {short.tolist()} below the maximum "
             f"(tolerance {tol.tolist()})")
    return float(short.max())


def head_sweep(V: int, H: int) -> dict:
    """Both routes of the head over the 0.6B table at each R of
    HEAD_SWEEP_ROWS, bf16 and int8: the crossover R* is the largest R of
    the sweep at which the CUDA-core route is still at least as fast."""
    import torch

    from smolvision_tpu_torch.kernels import argmax_matvec as am

    out = {}
    for kind in ("bfloat16", "int8"):
        rows = []
        for R in HEAD_SWEEP_ROWS:
            h, w, scale, _ = head_case(V, H, R, kind, 500 + R)
            core = time_ms(lambda: am.argmax_matvec(h, w, scale, route="cuda_core"))
            tc = time_ms(lambda: am.argmax_matvec(h, w, scale, route="tensor_core"))
            rows.append({"R": R, "cuda_core_ms": core, "tensor_core_ms": tc})
            del h, w, scale
        r_star = max((r["R"] for r in rows if r["cuda_core_ms"] <= r["tensor_core_ms"]), default=0)
        dtype = getattr(torch, kind)
        out[kind] = {"sweep": rows, "measured_r_star": r_star,
                     "source_r_star": am.HEAD_TC_ABOVE[dtype]}
        log(f"  head crossover sweep, {kind}: " + ", ".join(
            f"R {r['R']}: core {r['cuda_core_ms']:.4f} / tc {r['tensor_core_ms']:.4f}"
            for r in rows))
        log(f"  R* {kind}: measured {r_star} (the CUDA-core route at least as fast up to "
            f"it), source HEAD_TC_ABOVE {am.HEAD_TC_ABOVE[dtype]}")
    return out


def phase_heads(cfg, seg_B: int) -> list:
    """K6 (bf16) and K7 (int8) on both routes at each R of HEAD_CHECK_ROWS
    (the CUDA-core matvec and the tensor-core tile product; R 64 and 130
    are serving batches, R 130 wider than one tile of columns), K6 f32 at R
    1, exact ties across blocks and V not a multiple of any tile on both
    routes; then the crossover sweep; then timings: K6 at the single-stream
    head (R 1) and at the -S run's batch (R seg_B), K7 at R 1, K6 and K7 at
    R 64 (the serving width, tensor cores) beside cuBLAS + argmax, and K8
    over the lm_head, which sets the read bandwidth each head kernel is held
    against."""
    import torch

    from smolvision_tpu_torch.kernels import argmax_matvec as am
    from smolvision_tpu_torch.kernels import probes

    V, H = cfg.vocab_size, cfg.dec_hidden
    errs = {k: 0.0 for k in ("argmax_matvec", "argmax_matvec_tc", "argmax_matvec_q8",
                              "argmax_matvec_q8_tc")}
    cases = [(R, kind, planted, route) for R in HEAD_CHECK_ROWS for kind in ("bfloat16", "int8")
             for planted in (True, False) for route in ("cuda_core", "tensor_core")]
    cases += [(1, "float32", True, "cuda_core"), (1, "float32", False, "cuda_core")]
    for i, (R, kind, planted, route) in enumerate(cases):
        h, w, scale, winners = head_case(V, H, R, kind, 100 + i, planted)
        key = am.launch_key(route, w.dtype)
        err = check_head(f"{key} {kind} R={R} planted={planted}", h, w, scale, winners, route)
        errs[key] = max(errs[key], err)
        del h, w, scale
    for route in ("cuda_core", "tensor_core"):
        # an exact tie across blocks (rows 7 and V - 2): the first index wins
        for kind in ("bfloat16", "int8"):
            h, w, scale, _ = head_case(V, H, 1, kind, 200)
            w[V - 2] = w[7] = (torch.sign(h[0]) * (127 if kind == "int8" else 0.5)).to(w.dtype)
            if scale is not None:
                scale[V - 2] = scale[7]
            check_head(f"tie {kind} {route}", h, w, scale, [7], route)
        # V not a multiple of any block or tile, R > 8 (two row groups of the
        # CUDA-core route), R > 32 (two column tiles of the tensor-core route)
        for R in (11, 33):
            h, w, scale, winners = head_case(50_013, H, R, "bfloat16", 201 + R, planted=True)
            check_head(f"ragged V=50013 R={R} {route}", h, w, scale, winners, route)
    log(f"greedy heads vs plain: shortfall {json.dumps(errs)} (tolerance {HEAD_RTOL:g} of "
        f"max |logit|; planted winners, ties and ragged V equal)")
    sweep = head_sweep(V, H)

    rows = []
    for name, R, kind, replaces in (
            ("argmax_matvec", 1, "bfloat16", "tools/profile_decode2.py:127"),
            ("argmax_matvec_batched", seg_B, "bfloat16", "tools/profile_decode3.py:145"),
            ("argmax_matvec_q8", 1, "int8", "tools/probe_int8.py:110"),
            ("argmax_matvec_tc", SERVE_WIDE_SLOTS, "bfloat16", "tools/profile_decode3.py:145"),
            ("argmax_matvec_q8_tc", SERVE_WIDE_SLOTS, "int8", "tools/probe_int8.py:110")):
        h, w, scale, _ = head_case(V, H, R, kind, 300 + R)
        route = am.head_route(R, w.dtype)
        if name.endswith("_tc") and route != "tensor_core":
            fail(f"{name}: R {R} does not take the tensor-core route")
        err = check_head(f"{name} timing inputs", h, w, scale)
        key = am.launch_key(route, w.dtype)
        # one table read, plus h, the scales and the result
        nbytes = w.numel() * w.element_size() + (0 if scale is None else 4 * V) + 4 * R * (H + 1)
        lib = None
        if kind == "bfloat16":
            hb = h.to(torch.bfloat16)
            lib = (lambda hb=hb, w=w: torch.argmax(torch.mm(hb, w.t(), out_dtype=torch.float32),
                                                    dim=-1))
        rows.append({"name": name, "source": "smolvision_tpu_torch/kernels/csrc/argmax_matvec.cu",
                     "replaces": replaces, "err": max(errs[key], err), "R": R,
                     "design": route.replace("_", " ") + "s",
                     "kern": lambda h=h, w=w, s=scale: am.argmax_matvec(h, w, s),
                     "plain": lambda h=h, w=w, s=scale: am.argmax_matvec_plain(h, w, s),
                     "lib": lib, "bound": bound(nbytes, 2.0 * R * V * H, kind), "nbytes": nbytes})

    g = torch.Generator(device=DEV).manual_seed(400)
    x = (torch.randn(V, H, device=DEV, generator=g) * 0.05).to(torch.bfloat16)
    err = abs(float(probes.read_all(x, 0.25)) - float(probes.read_all_plain(x, 0.25)))
    if err != 0.0:
        fail(f"read_all: kernel and plain version differ by {err:g} (max is exact)")
    rows.append({"name": "read_all", "source": "smolvision_tpu_torch/kernels/csrc/probes.cu",
                 "replaces": "tools/profile_decode3.py:98", "err": err, "design": DESIGNS["read_all"],
                 "kern": lambda: probes.read_all(x, 0.25),
                 "plain": lambda: probes.read_all_plain(x, 0.25),
                 "lib": lambda: torch.amax(x), "nbytes": x.numel() * 2,
                 "bound": bound(x.numel() * 2 + 4, float(x.numel()), "bfloat16")})

    gm = torch.Generator(device=DEV).manual_seed(401)
    a, b = (torch.randn(256, 256, device=DEV, generator=gm) / 4 for _ in range(2))
    err = check_close("probe_mm", probes.probe_mm(a, b), probes.probe_mm_plain(a, b),
                      PROBE_MM_ATOL)
    rows.append({"name": "probe_mm", "source": "smolvision_tpu_torch/kernels/csrc/probes.cu",
                 "replaces": "tools/probe_compile_cache.py:35", "err": err,
                 "design": DESIGNS["probe_mm"],
                 "kern": lambda: probes.probe_mm(a, b), "plain": lambda: probes.probe_mm_plain(a, b),
                 "lib": lambda: torch.matmul(a, b), "nbytes": 3 * 256 * 256 * 4,
                 "bound": bound(3 * 256 * 256 * 4, 2.0 * 256 ** 3, "float32")})

    table = []
    for r in rows:
        p1, k1, k2, p2 = (time_ms(f) for f in (r["plain"], r["kern"], r["kern"], r["plain"]))
        lib_ms = time_ms(r["lib"]) if r["lib"] is not None else None
        bound_ms, bound_by = r["bound"]
        table.append({"name": r["name"], "route": "cuda", "source": r["source"],
                      "replaces": r["replaces"], "max_abs_err": r["err"], "ms": min(k1, k2),
                      "plain_ms": min(p1, p2), "library_ms": lib_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "nbytes": r["nbytes"], "design": r["design"],
                      "R": r.get("R")})
        log(f"  {r['name']}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, library "
            + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none (no one PyTorch call)")
            + f", bound {bound_ms:.4f} ms ({bound_by}); {r['design']}")
    read = next(t for t in table if t["name"] == "read_all")
    # the roofline's own read of the lm_head, counted as its path's launches
    from smolvision_tpu_torch.kernels import ffi

    ffi.reset_launch_counts()
    probes.read_all(x, 0.25)
    read["launches"] = ffi.launch_counts["read_all"]
    bw = read["nbytes"] / (read["ms"] * 1e-3)
    log(f"read roofline (K8 over the {read['nbytes'] / 1e6:.2f} MB lm_head): {bw / 1e12:.3f} TB/s "
        f"measured, {HBM_BYTES_PER_S / 1e12:.2f} TB/s data sheet")
    for t in table:
        if t["name"].startswith("argmax_matvec"):
            at_bw = t["nbytes"] / bw * 1e3
            log(f"  {t['name']} (R {t['R']}): {t['ms']:.4f} ms = {at_bw / t['ms']:.1%} of the "
                f"measured read rate ({at_bw:.4f} ms), {t['bound_ms'] / t['ms']:.1%} of the "
                f"data-sheet bound")
    log(f"head sweep: {json.dumps(sweep)}")
    return table


def build_cache_check() -> dict:
    """A fresh process builds again with nvcc unavailable: every library must
    come from kernels/build.py's source-hash cache; then K9 (probe_mm)
    launched from the cached library is held against torch.matmul."""
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from unittest import mock
import torch
from smolvision_tpu_torch.kernels import build, ffi, probes

def no_nvcc():
    raise RuntimeError("nvcc was called: a library was not in the build cache")

with mock.patch.object(build, "_nvcc", no_nvcc):
    logs = build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device="cuda").manual_seed(7)
a, b = (torch.randn(256, 256, device="cuda", generator=g) / 4 for _ in range(2))
torch.cuda.synchronize()
ffi.reset_launch_counts()
got = probes.probe_mm(a, b)
launches = ffi.launch_counts["probe_mm"]
want = torch.matmul(a, b)
torch.cuda.synchronize()
bad = (got - want).abs() > {PROBE_MM_ATOL!r}
print(json.dumps({{"built": [l.name for l in logs if l.seconds > 0],
                  "cached": [l.name for l in logs if l.seconds == 0],
                  "probe_mm_max_abs_err": float((got - want).abs().max()),
                  "probe_mm_launches": launches,
                  "probe_mm_wrong_outputs": int(bad.sum()),
                  "probe_mm_first_wrong": bad.nonzero()[:4].tolist()}}))
"""
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    if r.returncode != 0:
        fail(f"build-cache check exited {r.returncode}: {r.stderr.strip()[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["seconds"] = time.monotonic() - t0
    from smolvision_tpu_torch.kernels import build

    if out["built"] or sorted(out["cached"]) != sorted(build.LIBS):
        fail(f"build-cache check: not every library came from the cache: {out}")
    if not out["probe_mm_max_abs_err"] <= PROBE_MM_ATOL or out["probe_mm_launches"] != 1:
        fail(f"build-cache check: probe_mm from the cached library: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def speech_like(seconds: float, seed: int):
    """AM-modulated tones with pauses and a little noise (the tests'
    speech_like_audio fixture, stretched to `seconds`)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sr = 16000
    t = np.arange(int(sr * seconds)) / sr
    sig = (0.30 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
           + 0.15 * np.sin(2 * np.pi * 880 * t) * (t % 1.0 < 0.4)
           + 0.01 * rng.standard_normal(len(t)))
    for s0 in np.arange(1.4, seconds, 3.0):  # a pause every 3 s
        sig[int(s0 * sr): int((s0 + 0.3) * sr)] *= 0.02
    return sig.astype(np.float32)


def write_wav(path: str, samples, sr: int = 16000) -> None:
    import numpy as np

    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
                + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(pcm)) + pcm)


def main_path_shapes(model_dir: str, samples):
    """The attention shapes the main path will run on this clip."""
    from smolvision_tpu_torch.config import detect_config
    from smolvision_tpu_torch.models.qwen3_encoder import total_encoder_tokens
    from smolvision_tpu_torch.ops.mel import num_frames
    from smolvision_tpu_torch.runtime.buckets import bucket, window_bucket
    from smolvision_tpu_torch.runtime.engine import KV_HEADROOM
    from smolvision_tpu_torch.runtime.prompt import build_asr_prompt
    from smolvision_tpu_torch.text.tokenizer import load_tokenizer

    cfg = detect_config(model_dir)
    n_tok = total_encoder_tokens(num_frames(len(samples)), cfg)
    wts = cfg.window_token_size()
    W = window_bucket(n_tok, wts) // wts
    force = load_tokenizer(model_dir).encode("language English") + [151704]
    ids, _ = build_asr_prompt(cfg, n_tok, (), force)
    T = bucket(len(ids), 64)
    return {
        "window_lens": [min(max(n_tok - w * wts, 0), wts) for w in range(W)],
        "prompt_len": len(ids), "prefill_T": T,
        "kv_cap": bucket(T + KV_HEADROOM, 256),
        "decode_pos": len(ids) + MAX_TOKENS // 2,
    }


def batched_path_shapes(model_dir: str, long_clip, serve_clips, wide_clips):
    """The B4 shape of the -S run (all segments as one group: B, T, left
    pads), the B5 shapes of serving's first wave (Gcap, pcap, prompt
    lengths) under --serve 4 and under --serve 64, and B1's windows of the
    -S run's one encode call and of --serve 64's first encode group (the
    serving.ENCODE_GROUP longest clips), from host arithmetic only."""
    from smolvision_tpu_torch.config import SAMPLE_RATE, TOKEN_ASR_TEXT, detect_config
    from smolvision_tpu_torch.models.qwen3_encoder import total_encoder_tokens, window_lens
    from smolvision_tpu_torch.ops.mel import num_frames
    from smolvision_tpu_torch.runtime.buckets import bucket64, window_bucket
    from smolvision_tpu_torch.runtime.prompt import build_asr_prompt
    from smolvision_tpu_torch.runtime.segment import split_points
    from smolvision_tpu_torch.runtime.serving import ENCODE_GROUP
    from smolvision_tpu_torch.text.tokenizer import load_tokenizer

    cfg = detect_config(model_dir)
    force = load_tokenizer(model_dir).encode("language English") + [TOKEN_ASR_TEXT]
    wts = cfg.window_token_size()

    def enc_tokens(n_samples):
        return total_encoder_tokens(num_frames(n_samples), cfg)

    def prompt_len(n_samples):
        return len(build_asr_prompt(cfg, enc_tokens(n_samples), (), force)[0])

    def windows(sample_counts):
        """B1's kv_lens over one batched encode of these clips."""
        n_tok = [enc_tokens(n) for n in sample_counts]
        return window_lens(n_tok, max(window_bucket(n, wts) for n in n_tok) // wts, wts)

    def first_wave(clips, slots: int, key: str) -> dict:
        """serving.py's first admission wave: the longest min(slots, n)
        prompts, rows bucketed to a power of two (the last prompt repeated),
        T the longest prompt of the queue to a multiple of 64."""
        served = sorted((prompt_len(len(c)) for c in clips), reverse=True)
        G = min(slots, len(served))
        cap = 1 << (G - 1).bit_length()
        return {f"{key}_G": cap, f"{key}_T": bucket64(max(served)),
                f"{key}_lens": served[:G] + [served[G - 1]] * (cap - G)}

    splits = split_points(long_clip, SEGMENT_SEC, 3.0)
    seg_samples = [max(b - a, SAMPLE_RATE // 2) for a, b in zip(splits, splits[1:])]
    seg = [prompt_len(n) for n in seg_samples]
    T = bucket64(max(seg))
    wide_group = sorted((len(c) for c in wide_clips), reverse=True)[:ENCODE_GROUP]
    return {"seg_B": len(seg), "seg_T": T, "seg_pads": [T - n for n in seg],
            "seg_window_lens": windows(seg_samples), "wide_window_lens": windows(wide_group),
            **first_wave(serve_clips, SERVE_SLOTS, "serve"),
            **first_wave(wide_clips, SERVE_WIDE_SLOTS, "wide")}


def path_trace(eng, samples, steps: int, forced=None):
    """Encoder output, prefill logits and `steps` greedy choices with their
    top-2 logit gaps, through the engine's own primitives.  With `forced`,
    step i feeds forced[i] to the next step instead of its own choice (so
    two paths can be compared step by step on one token sequence)."""
    import torch

    from smolvision_tpu_torch.ops.mel import log_mel
    from smolvision_tpu_torch.runtime.prompt import build_asr_prompt

    with torch.inference_mode():
        enc, n_audio = eng.encode_mel(log_mel(samples))
        ids, a0 = build_asr_prompt(eng.cfg, n_audio, eng._prompt_tokens, eng._force_tokens)
        eng.reset_kv()
        logits, pos = eng.prefill_ids(ids, enc, a0, n_audio, greedy=False)
        prefill_logits = logits.float().clone()
        toks, gaps = [], []
        for i in range(steps):
            top = torch.topk(logits, 2).values
            gaps.append(float(top[0] - top[1]))
            toks.append(int(torch.argmax(logits)))
            logits = eng.decode_step(toks[-1] if forced is None else forced[i], pos,
                                     greedy=False)
            pos += 1
        return enc[:n_audio].float().clone(), prefill_logits, toks, gaps


def compare_paths(eng, samples, steps: int) -> dict:
    """The card's kernel path vs the card's plain path on the same engine."""
    import torch

    from smolvision_tpu_torch.kernels import flash_attention as fa

    rtol = PATH_RTOL[str(eng.param_dtype).replace("torch.", "")]

    kern = path_trace(eng, samples, steps)
    # the plain path is fed the kernel path's tokens: every step compares
    # the two choices after the same prefix
    with mock.patch.object(fa, "window_flash_attention", fa.window_attention_plain), \
            mock.patch.object(fa, "causal_cache_flash_attention",
                              lambda q, k, v, s, n, kv_min=0:
                              fa.causal_cache_attention_plain(q, k, v, s, n, kv_min)), \
            mock.patch.object(fa, "decode_flash_attention", fa.decode_attention_plain):
        plain = path_trace(eng, samples, steps, forced=kern[2])
    out = {}
    for i, name in ((0, "encoder"), (1, "prefill_logits")):
        if not (torch.isfinite(kern[i]).all() and torch.isfinite(plain[i]).all()):
            fail(f"{name}: non-finite values")
        err = float((kern[i] - plain[i]).abs().max())
        tol = rtol * float(plain[i].abs().max())
        out[name] = {"max_abs_err": err, "tolerance": tol}
        if not err <= tol:
            fail(f"kernel vs plain path: {name} max_abs_err {err:.4g} > {tol:.4g}")
    tol = out["prefill_logits"]["tolerance"]
    near_ties = []
    for i, (a, b, ga, gb) in enumerate(zip(kern[2], plain[2], kern[3], plain[3])):
        if min(ga, gb) < tol:
            near_ties.append(i)  # either token is a legitimate greedy choice
        elif a != b:
            fail(f"kernel vs plain path: greedy token {i} differs ({a} vs {b}) "
                 f"with top-2 gap {min(ga, gb):.4g} >= {tol:.4g}")
    out["greedy_steps"] = steps
    out["greedy_tokens_compared"] = steps - len(near_ties)
    out["first_near_tie"] = near_ties[0] if near_ties else None
    out["rtol"] = rtol
    return out


@contextlib.contextmanager
def decode_mode(mode: str):
    """The device loops and prefill graphs (runtime/decode_graph.py) as they
    ship ("graph": one CUDA graph of the step, replayed; a prefill's first
    call per (cache, block rows) eager, then captured) or with every replay
    and prefill running the step eagerly ("eager": decode_graph.capture
    returns the step itself).  Yields a record of every loop chunk's tokens
    and count, the chunks' host reads, the prefill graphs made (one per
    key), and the kind ("decode", "spec", "prefill") and launches per replay
    of every captured graph (not the graph: it holds its owner's cache and
    weights)."""
    from smolvision_tpu_torch.runtime import decode_graph

    rec = {"chunks": [], "graphs": [], "reads": 0, "prefill_keys": 0}

    def recording(run):
        def recording_run(self, *args, **kwargs):
            out = run(self, *args, **kwargs)
            rec["chunks"].append((out[0].tolist(), out[1]))
            return out
        return recording_run

    read = decode_graph._ChunkLoop._read

    def counting_read(*args):
        rec["reads"] += 1
        return read(*args)

    init = decode_graph.PrefillGraph.__init__

    def counting_init(self, *args, **kwargs):
        rec["prefill_keys"] += 1
        init(self, *args, **kwargs)

    class RecordingGraph(decode_graph.StepGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            rec["graphs"].append((self.kind, self.launches))

    with contextlib.ExitStack() as stack:
        for cls in (decode_graph.DecodeLoop, decode_graph.SpecLoop):
            stack.enter_context(mock.patch.object(cls, "run", recording(cls.run)))
        stack.enter_context(mock.patch.object(decode_graph._ChunkLoop, "_read",
                                              staticmethod(counting_read)))
        stack.enter_context(mock.patch.object(decode_graph.PrefillGraph, "__init__",
                                              counting_init))
        stack.enter_context(mock.patch.object(decode_graph, "StepGraph", RecordingGraph))
        if mode == "eager":
            stack.enter_context(mock.patch.object(decode_graph, "capture",
                                                  lambda step, stream: step))
        yield rec


def loop_windows(make_loop, tokens, pos: int, turns=("eager", "graph")) -> dict:
    """Decode ms per step and the device's idle share of `make_loop()`'s
    chunks of PROFILE_STEPS[mode] steps, eager and graph in turns, each
    loop warmed by one chunk first (its capture).  Each mode also runs one
    chunk untraced (host clock, synchronised): tracing slows a replay, so
    its idle share is also given against the untraced time per step."""
    import torch

    out = {}
    for i, mode in enumerate(turns):
        with decode_mode(mode):
            loop = make_loop()
            steps = PROFILE_STEPS[mode]
            _, count, _ = loop.run(tokens, pos, steps)
            state = {"tok": loop.tok.clone(), "pos": pos + count}

            def chunk():
                _, n, replays = loop.run(state["tok"], state["pos"], steps)
                state["tok"], state["pos"] = loop.tok.clone(), state["pos"] + n
                return replays

            if DEV == "cuda":
                torch.cuda.synchronize()
            t0 = time.monotonic()
            ran = chunk()   # ends in the chunk's host read, which waits for the card
            untraced = (time.monotonic() - t0) * 1e3 / max(ran, 1)
            window = profile_window(chunk)
            window["untraced_wall_ms_per_step"] = untraced
            window["untraced_idle_share"] = 1.0 - window["device_busy_ms_per_step"] / untraced
            out[f"{mode}_{i}"] = window
            del loop
    graph = [v for k, v in out.items() if k.startswith("graph")]
    eager = [v for k, v in out.items() if k.startswith("eager")]
    # the profiler must see the graph's kernels one by one for its busy time
    # to count: a replay that shows as fewer kernels than the eager step has
    # no idle share
    seen = min(g["kernels_per_step"] for g in graph) >= 0.95 * min(
        e["kernels_per_step"] for e in eager)
    summary = {"graph_ms_per_step": [g["wall_ms_per_step"] for g in graph],
               "eager_ms_per_step": [e["wall_ms_per_step"] for e in eager],
               "graph_untraced_ms_per_step": [g["untraced_wall_ms_per_step"] for g in graph],
               "eager_untraced_ms_per_step": [e["untraced_wall_ms_per_step"] for e in eager],
               "graph_untraced_idle_share": [g["untraced_idle_share"] for g in graph],
               "eager_untraced_idle_share": [e["untraced_idle_share"] for e in eager],
               "graph_busy_ms_per_step": [g["device_busy_ms_per_step"] for g in graph],
               "eager_busy_ms_per_step": [e["device_busy_ms_per_step"] for e in eager],
               "graph_idle_share": ([g["device_idle_share"] for g in graph] if seen
                                    else "not measured: the profiler did not list the "
                                         "replays' kernels"),
               "eager_idle_share": [e["device_idle_share"] for e in eager],
               "kernels_per_step": {"graph": graph[0]["kernels_per_step"],
                                    "eager": eager[0]["kernels_per_step"]},
               "windows": out}
    return summary


def profile_decode(eng, samples) -> dict:
    """The single-stream decode loop after the main path's prefill, eager
    and graph in turns (`loop_windows`: eager, graph, graph, eager)."""
    import torch

    from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
    from smolvision_tpu_torch.ops.mel import log_mel
    from smolvision_tpu_torch.runtime.decode_graph import DecodeLoop
    from smolvision_tpu_torch.runtime.prompt import build_asr_prompt

    with torch.inference_mode():
        enc, n_audio = eng.encode_mel(log_mel(samples))
        ids, a0 = build_asr_prompt(eng.cfg, n_audio, eng._prompt_tokens, eng._force_tokens)
        eng.reset_kv()
        tok, pos = eng.prefill_ids(ids, enc, a0, n_audio)
        kv = eng._ensure_kv(pos + 4 * PROFILE_STEPS["graph"])
        p, cfg = eng.dec_params, eng.cfg
        return loop_windows(lambda: DecodeLoop(
            lambda t, at: dec_mod.decode_step(p, cfg, t, at, kv)[0].reshape(1),
            1, kv, eng._kv_cap, eng.device, None), int(tok), pos,
            ("eager", "graph", "graph", "eager"))


def replay_launches(eng, cfg, batch: int) -> dict:
    """The launches one replay makes, by graph kind: a single-stream decode
    step (batch 0) B3 once per layer and the head once; a --spec iteration
    SPEC_DRAFT int8 steps (B3 per layer, K7 at R 1 each), the verify (B2
    per layer) and its head at R SPEC_DRAFT + 1; a prefill B2 per layer and
    the head at R 1; a batched step the head once at R B (its attention is
    plain torch)."""
    import torch

    from smolvision_tpu_torch.kernels import argmax_matvec as am
    from smolvision_tpu_torch.ops.quant import QuantW
    from smolvision_tpu_torch.runtime import engine as eng_mod

    head = eng.dec_params["lm_head"]
    dtype = torch.int8 if isinstance(head, QuantW) else head.dtype

    def key(R: int, w_dtype=dtype) -> str:
        return am.launch_key(am.head_route(R, w_dtype), w_dtype)

    L, n = cfg.dec_layers, eng_mod.SPEC_DRAFT
    out = {"prefill": {"causal_cache_attention": L, key(1): 1}}
    if batch:
        out["decode"] = {key(batch): 1}
    else:
        out["decode"] = {"decode_attention": L, key(1): 1}
        spec = {"decode_attention": n * L, key(1, torch.int8): n, "causal_cache_attention": L}
        spec[key(n + 1)] = spec.get(key(n + 1), 0) + 1
        out["spec"] = spec
    return out


def decode_ms_per_step(perf) -> float:
    if perf.batch_decode_steps:
        return perf.batch_decode_ms / perf.batch_decode_steps
    return (perf.decode_ms - perf.prefill_ms) / max(perf.decode_steps, 1)


def run_path(argv, name: str, cfg, batch: int = 0, wave: int = 0):
    """One path through the CLI twice, in turns: the decode loops' steps and
    the prefills run eagerly, then as CUDA graphs.  Each run's launches must
    equal its own bookkeeping; the two runs' decoded chunks (tokens and
    counts) must be equal; every graph must launch its step's kernels once
    per replay; the loops read the host once per chunk; the prefill graphs
    captured are at most their (cache, block rows) keys.  Returns the graph
    run's (engine, launches, stdout lines, wall s)."""
    import gc

    import torch

    runs = {}
    for mode in ("eager", "graph"):
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with decode_mode(mode) as rec:
            eng, launches, lines, wall_s = run_cli(argv, f"{name} ({mode})")
        check_launches(f"{name} ({mode})", launches, eng, cfg, batch, wave)
        perf = eng.perf
        if rec["reads"] != len(rec["chunks"]):
            fail(f"{name} ({mode}): {rec['reads']} host reads over {len(rec['chunks'])} chunks")
        if perf.prefill_captures > rec["prefill_keys"]:
            fail(f"{name} ({mode}): {perf.prefill_captures} prefill graphs captured over "
                 f"{rec['prefill_keys']} (cache, block rows) keys")
        runs[mode] = {"rec": rec, "lines": lines,
                      "decode_ms_per_step": decode_ms_per_step(perf),
                      "steps": perf.decode_steps + perf.batch_decode_steps,
                      "wasted_steps": perf.wasted_steps, "captures": perf.graph_captures,
                      "capture_ms": perf.graph_capture_ms, "wall_s": wall_s,
                      "host_reads": rec["reads"], "prefills": perf.prefills,
                      "prefill_ms": perf.prefill_ms,
                      "prefill_ms_per_call": perf.prefill_ms / max(perf.prefills, 1),
                      "prefill_keys": rec["prefill_keys"],
                      "prefill_captures": perf.prefill_captures,
                      "prefill_capture_ms": perf.prefill_capture_ms,
                      "prefill_replays": perf.prefill_replays,
                      "realtime_factor": perf.audio_ms / max(perf.total_ms, 1e-9),
                      "max_memory_allocated_gib":
                          torch.cuda.max_memory_allocated() / 2**30 if DEV == "cuda" else 0.0}
        if perf.spec_iters:
            runs[mode].update(spec_iters=perf.spec_iters, spec_tokens=perf.spec_tokens,
                              decode_ms_per_token=(perf.decode_ms - perf.prefill_ms)
                              / perf.spec_tokens)
        if mode == "eager":
            del eng
            gc.collect()
    eager, graph = runs["eager"], runs["graph"]
    if not graph["rec"]["chunks"]:
        fail(f"{name}: no decode chunk ran")
    if graph["rec"]["chunks"] != eager["rec"]["chunks"] or graph["lines"] != eager["lines"]:
        first = next((i for i, (a, b) in enumerate(zip(graph["rec"]["chunks"],
                                                       eager["rec"]["chunks"])) if a != b), None)
        fail(f"{name}: the graph run's decoded chunks differ from the eager run's (first at "
             f"chunk {first} of {len(graph['rec']['chunks'])} / {len(eager['rec']['chunks'])})")
    want = replay_launches(eng, cfg, batch)
    graphs = graph["rec"]["graphs"]
    loop_kind = "spec" if eng.spec and not batch else "decode"
    if DEV == "cuda" and (not any(k == loop_kind for k, _ in graphs)
                          or any(launched != want.get(k) for k, launched in graphs)):
        fail(f"{name}: launches per replay {graphs}, expected {want}")
    if any(launched for _, launched in eager["rec"]["graphs"]):
        fail(f"{name}: an eager step was captured as a graph")
    summary = {"tokens_equal_chunks": len(graph["rec"]["chunks"]),
               "launches_per_replay": want[loop_kind],
               "graphs": sum(1 for k, _ in graphs if k != "prefill"),
               "prefill_graphs": sum(1 for k, _ in graphs if k == "prefill")}
    for key in ("decode_ms_per_step", "steps", "wasted_steps", "captures", "capture_ms",
                "wall_s", "host_reads", "prefills", "prefill_ms", "prefill_ms_per_call",
                "prefill_keys", "prefill_captures", "prefill_capture_ms", "prefill_replays",
                "realtime_factor", "spec_iters", "spec_tokens", "decode_ms_per_token",
                "max_memory_allocated_gib"):
        if key in graph:
            summary[key] = {"eager": eager[key], "graph": graph[key]}
    DECODE_RUNS[name] = summary
    log(f"  {name}: graph vs eager: {json.dumps(summary)}")
    return eng, launches, graph["lines"], graph["wall_s"]


def phase_main_path(model_dir: str, wav: str, cfg):
    argv = ["-d", model_dir, "-i", wav, "--silent", "--language", "English",
            "--max-tokens", str(MAX_TOKENS)]
    eng, launches, lines, wall_s = run_path(argv, "main path", cfg)
    transcript = "\n".join(lines).strip()
    if not transcript:
        fail("empty transcript")
    perf = eng.perf
    log(f"main path: {wall_s:.2f} s wall incl. load ({perf.decode_steps} decode steps)")
    if (perf.encodes, perf.prefills) != (1, 1) or perf.decode_steps == 0:
        fail(f"main path: {perf.encodes} encodes, {perf.prefills} prefills, "
             f"{perf.decode_steps} decode steps (expected 1, 1, > 0)")
    log(f"  transcript ({perf.text_tokens} text tokens): {transcript[:120]}")
    log(f"  graph run, second in the process: {perf_line(perf)}, max_memory_allocated "
        f"{DECODE_RUNS['main path']['max_memory_allocated_gib']['graph']:.3f} GiB")
    return eng, launches


def run_cli(argv, name: str, stdin=None):
    """One CLI run with the launch counts set to 0 just before it (and
    sys.stdin replaced by `stdin` if given); returns (engine, launches,
    stdout lines, wall seconds).  Its stdout is bytes underneath, as the
    CLI writes streamed pieces to sys.stdout.buffer."""
    import torch

    from smolvision_tpu_torch import cli
    from smolvision_tpu_torch.kernels import ffi

    if DEV == "cuda":
        torch.cuda.synchronize()
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    ffi.reset_launch_counts()
    t0 = time.monotonic()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(out))
        if stdin is not None:
            stack.enter_context(mock.patch.object(sys, "stdin", stdin))
        rc, eng = cli.run(argv)
    if DEV == "cuda":
        torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = dict(ffi.launch_counts)
    if rc != 0 or eng is None:
        fail(f"{name}: cli exited {rc}")
    out.flush()
    return eng, launches, raw.getvalue().decode("utf-8", errors="replace").splitlines(), wall_s


def check_launches(name: str, launches: dict, eng, cfg, batch: int = 0, wave: int = 0) -> None:
    """Every kernel's launches equal the path's own bookkeeping: one per
    layer per encoder call, single prefill, --spec verify (the iterations
    replayed past a chunk's end included), decode step,
    batched fresh prefill and batched delta prefill (none on an int8
    cache, which runs the two-part attention), and one greedy head per
    prefill, decode step, verify and batched step -- int8 (K7) under --q8
    and for the --spec draft steps, else K6 -- each under the launch key of
    the route `head_route` gives its rows: 1 for the single-stream heads,
    SPEC_DRAFT + 1 for a verify, `batch` for a batched fresh prefill or
    decode step, `wave` for a delta prefill (a serving wave)."""
    import torch

    from smolvision_tpu_torch.kernels import argmax_matvec as am
    from smolvision_tpu_torch.ops.quant import QuantW
    from smolvision_tpu_torch.runtime import engine as eng_mod

    perf = eng.perf
    L = cfg.dec_layers
    head = eng.dec_params["lm_head"]
    dtype = torch.int8 if isinstance(head, QuantW) else head.dtype
    # --spec: replays past a chunk's end (wasted_steps) are whole iterations
    wasted = perf.wasted_steps if eng.spec else 0
    iters, drafts = perf.spec_iters + wasted, perf.decode_steps + eng_mod.SPEC_DRAFT * wasted
    expected = {k: 0 for k in launches}
    expected.update({"window_attention": cfg.enc_layers * perf.encodes,
                     "causal_cache_attention": L * (perf.prefills + iters),
                     "decode_attention": L * drafts,
                     "batched_causal_attention": L * perf.fresh_prefills,
                     "batched_cache_attention": 0 if eng.kv8 else L * perf.delta_prefills})

    def heads(n: int, R: int, w_dtype) -> None:
        if n:
            expected[am.launch_key(am.head_route(R, w_dtype), w_dtype)] += n

    heads(perf.prefills, 1, dtype)
    heads(drafts, 1, torch.int8 if eng.spec else dtype)   # --spec: the draft
    heads(iters, eng_mod.SPEC_DRAFT + 1, dtype)
    heads(perf.fresh_prefills + perf.batch_decode_steps, batch, dtype)
    heads(perf.delta_prefills, wave, dtype)
    log(f"{name}: launches {json.dumps(launches)}, expected {json.dumps(expected)}")
    if launches != expected:
        fail(f"{name}: launch counts {launches} != expected {expected}")


def batch_perf_line(perf, batch: int) -> str:
    dec_ms = perf.batch_decode_ms
    steps = perf.batch_decode_steps
    return (f"realtime factor {perf.audio_ms / perf.total_ms:.2f}x "
            f"({perf.audio_ms / 1000:.1f} s audio in {perf.total_ms:.2f} ms), "
            f"encode {perf.encode_ms:.2f} ms ({perf.encodes} calls), "
            f"prefill {perf.prefill_ms:.2f} ms, batched decode {dec_ms:.2f} ms "
            f"({steps} steps at B {batch}: {dec_ms / max(steps, 1):.2f} ms/step), "
            f"{perf.text_tokens} text tokens")


def profile_window(run) -> dict:
    """Device busy time, idle share and the top kernels of one call of
    `run()`, which returns the decode steps it ran (torch.profiler), against
    the host wall clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        steps = run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # device-side entries only (kernels, memcpy/memset): the CPU ops that
    # launched them report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    steps = max(steps, 1)
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "kernels_per_step": sum(e.count for e in events) / steps,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / steps
                                    for e in top},
    }


def batched_inputs(eng, B: int, T: int, seed: int):
    """Embeddings of random token ids [B, T, H] (through the embedding
    table, so their scale is the model's) and random left pads."""
    import torch

    from smolvision_tpu_torch.ops.quant import embed_rows

    g = torch.Generator(device="cpu").manual_seed(seed)
    ids = torch.randint(0, eng.cfg.vocab_size, (B, T), generator=g).to(eng.device)
    pads = torch.randint(0, T // 2, (B,), generator=g).to(torch.int32).to(eng.device)
    pads[0] = 0
    return embed_rows(eng.dec_params["embed"], ids), pads


def profile_batched_decode(eng, B: int, T: int, natural: bool = False) -> dict:
    """The batched decode loop at batch B after a fresh prefill of T rows
    (serving's natural-layout masks with `natural`), eager and graph in
    turns (`loop_windows`)."""
    import torch

    from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
    from smolvision_tpu_torch.parallel import batch as pbatch

    with torch.inference_mode():
        emb, pads = batched_inputs(eng, B, T, 3)
        kv = pbatch.make_batched_kv(eng.cfg, B, T + 4 * PROFILE_STEPS["graph"],
                                    eng.batched_kv_dtype, eng.device)
        tok, kv = dec_mod.batched_prefill(eng.dec_params, eng.cfg, emb, kv, -pads, pads)
        inputs = {"rope_offset": pads, "kv_min": pads}
        if natural:
            inputs.update(prompt_max=torch.full_like(pads, T),
                          region_start=torch.full_like(pads, T))

        class Loop:
            """The batched loop with this window's inputs bound."""

            def __init__(self):
                self.inner = pbatch.batched_decode_loop(eng.dec_params, eng.cfg, kv, B,
                                                        natural=natural)
                self.tok = self.inner.tok

            def run(self, tokens, pos, steps):
                return self.inner.run(tokens, pos, steps, **inputs)

        return loop_windows(Loop, tok, T)


def compare_batched_paths(eng, B: int, T: int) -> dict:
    """Kernel path vs plain path on the card: batched fresh-prefill logits
    (B4) and delta-prefill logits at start 0 with per-row prompt lengths
    (B5, serving) and at start > 0 with per-row prompt_max / region_start
    (B5's cache half)."""
    import torch

    from smolvision_tpu_torch.kernels import flash_attention as fa
    from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
    from smolvision_tpu_torch.parallel import batch as pbatch

    rtol = PATH_RTOL[str(eng.param_dtype).replace("torch.", "")]
    cfg, p, dev = eng.cfg, eng.dec_params, eng.device

    def run():
        with torch.inference_mode():
            emb, pads = batched_inputs(eng, B, T, 5)
            tail, _ = batched_inputs(eng, B, 64, 6)
            kv = pbatch.make_batched_kv(cfg, B, T + 64, eng.batched_kv_dtype, dev)
            fresh, kv = dec_mod.batched_prefill(p, cfg, emb, kv, -pads, pads, greedy=False)
            lens = T - pads
            small = pbatch.make_batched_kv(cfg, B, T, eng.batched_kv_dtype, dev)
            z = torch.zeros_like(pads)
            served, _ = dec_mod.batched_prefill_delta(p, cfg, emb, 0, small, z, z, greedy=False,
                                                      last_rows=lens - 1, prompt_max=lens,
                                                      region_start=1 << 30)
            rs = torch.full_like(pads, T) - 32
            delta, _ = dec_mod.batched_prefill_delta(p, cfg, tail, T, kv, T - pads, pads,
                                                     greedy=False, prompt_max=rs - 16,
                                                     region_start=rs)
            return {"fresh_prefill_logits": fresh.float(), "served_prefill_logits": served.float(),
                    "delta_prefill_logits": delta.float()}

    kern = run()
    with mock.patch.object(fa, "batched_causal_flash_attention",
                           fa.batched_causal_attention_plain), \
            mock.patch.object(fa, "batched_cache_flash_attention",
                              fa.batched_cache_attention_plain):
        plain = run()
    out = {"rtol": rtol}
    for name in kern:
        a, b = kern[name], plain[name]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"batched {name}: non-finite values")
        err = float((a - b).abs().max())
        tol = rtol * float(b.abs().max())
        out[name] = {"max_abs_err": err, "tolerance": tol,
                     "argmax_equal": int((a.argmax(-1) == b.argmax(-1)).sum()), "rows": B}
        if not err <= tol:
            fail(f"batched kernel vs plain path: {name} max_abs_err {err:.4g} > {tol:.4g}")
    return out


def profile_path(name: str, eng, B: int, T: int, natural: bool = False) -> None:
    """The path's batched decode loop at its batch, cache and weights, eager
    and graph in turns; kept in its DECODE_RUNS entry."""
    prof = profile_batched_decode(eng, B, T, natural)
    DECODE_RUNS[name]["profile"] = {k: v for k, v in prof.items() if k != "windows"}
    log(f"  {name} decode loop at B {B}, eager and graph in turns: {json.dumps(prof)}")


def phase_segments(model_dir: str, wav: str, cfg, batch: int, T: int, extra=()):
    """-S 20 on the long clip through the CLI: batched encode, one B4 launch
    per layer per length group, batched decode."""
    argv = ["-d", model_dir, "-i", wav, "-S", str(SEGMENT_SEC), "--silent", "--language",
            "English", "--max-tokens", str(MAX_TOKENS), *extra]
    name = " ".join([f"-S {SEGMENT_SEC}", *extra]) + " run"
    eng, launches, lines, wall_s = run_path(argv, name, cfg, batch=batch)
    perf = eng.perf
    log(f"{name}: {wall_s:.2f} s wall incl. load; {perf.fresh_prefills} length "
        f"group(s), {perf.encodes} batched encode(s)")
    if perf.fresh_prefills == 0 or perf.batch_decode_steps == 0:
        fail("-S run: no batched prefill or decode step ran")
    if perf.prefills or perf.decode_steps:
        fail("-S run: segments went through the single-stream path")
    if len(lines) != 1 or not lines[0].strip():
        fail(f"-S run: expected one transcript line, got {lines!r}")
    log(f"  transcript ({perf.text_tokens} text tokens): {lines[0][:120]}")
    log(f"  {name} perf: {batch_perf_line(perf, batch)}")
    profile_path(name, eng, batch, T)
    return eng, launches


def serving_widths(n_clips: int, slots: int):
    """(batch rows per decode step, rows per admission wave) of `--serve
    slots` over n_clips clips queued at once (runtime/serving.py: S slots,
    waves of min(S, queued) clips bucketed to a power of two)."""
    S = min(slots, max(2, 1 << (n_clips - 1).bit_length()))
    G = min(S, n_clips)
    return S, 1 << (G - 1).bit_length() if G > 1 else 1


def phase_serving(model_dir: str, wavs, cfg, T: int, extra=(), slots: int = SERVE_SLOTS,
                  max_tokens: int = SERVE_MAX_TOKENS, min_waves: int = 2):
    """--serve over the clips: admission waves prefilled by B5 (by the
    two-part attention under --kv8)."""
    argv = ["-d", model_dir, "-i", *wavs, "--serve", str(slots), "--silent",
            "--language", "English", "--max-tokens", str(max_tokens), *extra]
    name = " ".join([f"--serve {slots}", *extra]) + " run"
    batch, wave = serving_widths(len(wavs), slots)
    eng, launches, lines, wall_s = run_path(argv, name, cfg, batch=batch, wave=wave)
    perf = eng.perf
    log(f"{name}: {wall_s:.2f} s wall incl. load; {len(wavs)} clips, "
        f"{perf.delta_prefills} admission waves of {wave} rows, decode at B {batch}")
    if perf.delta_prefills < min_waves:
        fail(f"--serve run: {perf.delta_prefills} admission wave(s), expected at least "
             f"{min_waves}")
    if len(lines) != len(wavs):
        fail(f"--serve run: {len(lines)} transcript lines for {len(wavs)} clips")
    lat = perf.serving_latency
    log(f"  {name} perf: {batch_perf_line(perf, batch)}")
    log(f"  serving latency (ms): {json.dumps(lat)}")
    profile_path(name, eng, batch, T, natural=True)
    return eng, launches


def phase_serving_wide(model_dir: str, wavs, cfg, T: int) -> dict:
    """--serve 64 (the JAX package's documented serving width) on 64 clips,
    bf16 and --q8: every greedy head of the run is 64 rows wide and must
    take the tensor-core route (K6 / K7 tc = waves + steps, the CUDA-core
    head 0 times).  Returns the launches of each run."""
    runs = {}
    for extra in ((), ("--q8",)):
        eng, launches = phase_serving(model_dir, wavs, cfg, T, extra, SERVE_WIDE_SLOTS,
                                      SERVE_WIDE_MAX_TOKENS, min_waves=1)
        perf = eng.perf
        q8 = "_q8" if extra else ""
        heads = perf.delta_prefills + perf.batch_decode_steps
        if (launches[f"argmax_matvec{q8}_tc"], launches[f"argmax_matvec{q8}"]) != (heads, 0):
            fail(f"--serve {SERVE_WIDE_SLOTS} {' '.join(extra)}: tensor-core heads "
                 f"{launches[f'argmax_matvec{q8}_tc']}, CUDA-core heads "
                 f"{launches[f'argmax_matvec{q8}']} (expected {heads} and 0)")
        log(f"  --serve {SERVE_WIDE_SLOTS} {' '.join(extra)}: decode "
            f"{perf.batch_decode_ms / max(perf.batch_decode_steps, 1):.2f} ms per step at B "
            f"{SERVE_WIDE_SLOTS} ({perf.batch_decode_steps} steps); the head on the tensor "
            f"cores {heads} times")
        runs[extra[0] if extra else "bf16"] = launches
        del eng
    return runs


def greedy_run(eng, samples, max_tokens: int, spec: bool) -> list:
    """The tokens decode_greedy shows its caller (prefill token first, up
    to the first EOS), with the engine's --spec switch set to `spec`."""
    import torch

    from smolvision_tpu_torch.ops.mel import log_mel
    from smolvision_tpu_torch.runtime.prompt import build_asr_prompt

    eng.spec = spec
    with torch.inference_mode():
        enc, n_audio = eng.encode_mel(log_mel(samples))
        ids, a0 = build_asr_prompt(eng.cfg, n_audio, eng._prompt_tokens, eng._force_tokens)
        eng.reset_kv()
        first, pos = eng.prefill_ids(ids, enc, a0, n_audio)
        out = []
        eng.decode_greedy(first, pos, max_tokens, lambda t: out.append(t) or True)
    return out


def spec_vs_plain(eng, samples, max_tokens: int, exact: bool) -> dict:
    """--spec tokens against the same engine's plain greedy tokens.  exact:
    equal over the whole run (f32 weights).  Otherwise (bf16) equal up to
    the first position where the plain path's top-2 logit gap is below
    PATH_RTOL of the largest prefill logit; the gap there is reported."""
    from smolvision_tpu_torch.runtime import engine as eng_mod

    eng.perf.reset()
    spec = greedy_run(eng, samples, max_tokens, spec=True)
    iters, produced = eng.perf.spec_iters, eng.perf.spec_tokens
    plain = greedy_run(eng, samples, max_tokens, spec=False)
    eng.spec = True
    n = min(len(spec), len(plain))
    part = next((i for i in range(n) if spec[i] != plain[i]),
                None if len(spec) == len(plain) else n)
    out = {"tokens": len(spec), "plain_tokens": len(plain), "equal_prefix": n if part is None
           else part, "spec_iters": iters, "spec_draft": eng_mod.SPEC_DRAFT,
           "tokens_per_verify": produced / max(iters, 1)}
    if part is not None:
        if exact:
            fail(f"--spec tokens part from plain greedy at position {part}: "
                 f"{spec[part:part + 4]} vs {plain[part:part + 4]}")
        _, logits0, _, gaps = path_trace(eng, samples, part + 1, forced=plain + [0])
        tol = PATH_RTOL[str(eng.param_dtype).replace("torch.", "")] * float(logits0.abs().max())
        out.update(parting_gap=gaps[part], gap_bound=tol)
        log(f"  --spec parts from plain greedy at token {part}: plain top-2 gap there "
            f"{gaps[part]:.4g} (bound {tol:.4g})")
        if not gaps[part] < tol:
            fail(f"--spec tokens part from plain greedy at position {part} where the plain "
                 f"top-2 gap {gaps[part]:.4g} >= {tol:.4g}")
    return out


def phase_int8(model_dir: str, wav: str, long_wav: str, serve_wavs, cfg, shapes) -> dict:
    """--q8 and --spec on the 20 s clip (each eager then graph, `run_path`:
    --spec's graph is one speculative iteration, replayed), -S 20 --q8
    --kv8 on the 120 s clip and --serve 4 --kv8 on the 8 clips, each
    checked against engine.perf; then the q8 kernel path against its plain
    path and --spec against plain greedy on bf16 weights.  Returns the
    launches of each run, and the --spec run's B2 launches at the verify's
    T (`--spec verify`)."""
    from smolvision_tpu_torch.io.wav import load_wav
    from smolvision_tpu_torch.runtime import engine as eng_mod

    clip = load_wav(wav)
    runs = {}
    base = ["-d", model_dir, "-i", wav, "--silent", "--language", "English", "--max-tokens",
            str(MAX_TOKENS)]
    for flag in ("--q8", "--spec"):
        eng, launches, lines, wall_s = run_path(base + [flag], f"{flag} run", cfg)
        perf = eng.perf
        log(f"{flag} run: {wall_s:.2f} s wall incl. load ({perf.decode_steps} decode steps, "
            f"{perf.spec_iters} verify iterations)")
        if perf.prefills != 1 or (flag == "--q8") != eng.q8 or (flag == "--spec") != eng.spec:
            fail(f"{flag} run: {perf.prefills} prefills, q8 {eng.q8}, spec {eng.spec}")
        if flag == "--spec" and (perf.spec_iters == 0
                                 or perf.decode_steps != eng_mod.SPEC_DRAFT * perf.spec_iters):
            fail(f"--spec run: {perf.spec_iters} verifies, {perf.decode_steps} draft steps")
        log(f"  transcript ({perf.text_tokens} text tokens): {' '.join(lines)[:120]}")
        log(f"  {flag} run perf: {perf_line(perf)}")
        if flag == "--q8":
            prof = profile_decode(eng, clip)
            DECODE_RUNS["--q8 run"]["profile"] = {k: v for k, v in prof.items()
                                                  if k != "windows"}
            log(f"  --q8 decode loop, eager and graph in turns: {json.dumps(prof)}")
            cmp = compare_paths(eng, clip, steps=MAX_TOKENS // 2)
            log(f"kernel path vs plain path on the card, --q8 weights: {json.dumps(cmp)}")
        else:
            run = DECODE_RUNS[f"{flag} run"]
            if not run["host_reads"]["graph"] < perf.spec_iters:
                fail(f"--spec run: {run['host_reads']['graph']} host reads for "
                     f"{perf.spec_iters} iterations (one per chunk expected)")
            runs["--spec verify"] = cfg.dec_layers * (perf.spec_iters + perf.wasted_steps)
            log(f"  accepted tokens per verify: {perf.spec_tokens / perf.spec_iters:.3f} "
                f"({perf.spec_tokens} tokens / {perf.spec_iters} verifies, draft "
                f"{eng_mod.SPEC_DRAFT}; {perf.wasted_steps} iterations replayed past a "
                f"chunk's end; {run['host_reads']['graph']} host reads); decode ms per token "
                f"graph {run['decode_ms_per_token']['graph']:.3f}, eager "
                f"{run['decode_ms_per_token']['eager']:.3f}")
            cmp = spec_vs_plain(eng, clip, MAX_TOKENS, exact=False)
            log(f"--spec vs plain greedy on the card, bf16 weights: {json.dumps(cmp)}")
        runs[flag] = launches
        del eng
    eng, runs["-S q8 kv8"] = phase_segments(model_dir, long_wav, cfg, shapes["seg_B"],
                                            shapes["seg_T"], extra=("--q8", "--kv8"))
    del eng
    eng, runs["--serve kv8"] = phase_serving(model_dir, serve_wavs, cfg, shapes["serve_T"],
                                             extra=("--kv8",))
    del eng
    return runs


def perf_line(perf) -> str:
    enc_ms = perf.encode_ms - perf.mel_ms
    dec_ms = perf.decode_ms - perf.prefill_ms
    return (f"mel {perf.mel_ms:.2f} ms, encode {enc_ms:.2f} ms, "
            f"prefill {perf.prefill_ms:.2f} ms, decode {dec_ms:.2f} ms "
            f"({perf.decode_steps} steps, "
            f"{1000.0 * perf.decode_steps / max(dec_ms, 1e-9):.2f} steps/s), "
            f"total {perf.total_ms:.2f} ms, "
            f"{1000.0 * perf.text_tokens / perf.total_ms:.2f} tok/s, "
            f"realtime factor {perf.audio_ms / perf.total_ms:.2f}x")


def warm_run(eng, samples) -> str:
    """The same transcription again on the warm engine (no first-call
    library set-up): the steady-state cost of one request."""
    from smolvision_tpu_torch.config import SAMPLE_RATE

    eng.perf.reset()
    eng.perf.audio_ms = 1000.0 * len(samples) / SAMPLE_RATE
    eng.transcribe_segment(samples)
    return perf_line(eng.perf)


# ---------------------------------------------------------------------------
# phase 9: streaming and live input
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def stream_record(audio: bool = False):
    """Records each stream (runtime/stream.py) the block runs: per chunk its
    index, reused rows and raw tokens (and with `audio` its audio rows, on
    the host); the session's prefill rows and reused rows; the KV caches
    allocated (the first and each growth); and every single-stream prefill
    as (cache, block rows T, start): those at start > 0 are the KV-reuse
    deltas (B2 once per layer each, eager or replayed), and the distinct
    (cache, T) are the prefill graphs' keys.  The wrappers only record; the
    calls they wrap run as they ship."""
    from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
    from smolvision_tpu_torch.runtime import stream
    from smolvision_tpu_torch.runtime.engine import Engine

    runs = []
    init, finish, final = (stream.StreamState.__init__, stream.StreamState.finish_chunk,
                           stream.StreamState.finalize)
    make_kv, prefill = dec_mod.make_kv_cache, Engine._prefill

    def rec_init(self, *args, **kwargs):
        runs.append({"chunks": [], "allocs": 0, "prefills": [], "audio": []})
        init(self, *args, **kwargs)

    def rec_finish(self, w, *args, **kwargs):
        finish(self, w, *args, **kwargs)
        runs[-1]["chunks"].append((self.chunk_idx - 1, w.reused, list(self.raw_tokens)))
        runs[-1]["last_work"] = w
        if audio:
            runs[-1]["audio"].append(w.audio_block[: w.enc_seq_len].float().cpu())

    def rec_final(self):
        runs[-1].update(prefill_total=self.prefill_total, prefill_reused=self.prefill_reused)
        return final(self)

    def rec_make_kv(*args, **kwargs):
        if runs:
            runs[-1]["allocs"] += 1
        return make_kv(*args, **kwargs)

    def rec_prefill(self, embeds, start_pos, *args, **kwargs):
        out = prefill(self, embeds, start_pos, *args, **kwargs)
        if runs:   # after the call: a first prefill allocates its cache
            runs[-1]["prefills"].append((runs[-1]["allocs"], embeds.shape[0], start_pos))
        return out

    with contextlib.ExitStack() as stack:
        for obj, attr, fn in ((stream.StreamState, "__init__", rec_init),
                              (stream.StreamState, "finish_chunk", rec_finish),
                              (stream.StreamState, "finalize", rec_final),
                              (dec_mod, "make_kv_cache", rec_make_kv),
                              (Engine, "_prefill", rec_prefill)):
            stack.enter_context(mock.patch.object(obj, attr, fn))
        yield runs


def b2_deltas(run: dict) -> list:
    """A stream record's prefills at start > 0, as (T, start)."""
    return [(T, start) for _, T, start in run["prefills"] if start > 0]


def stream_summary(name: str, eng, run: dict, cfg, wall_s: float) -> dict:
    """What a stream run shows (its realtime factor, chunk latency, the
    phase times, the reused share of prefill rows, graph captures against
    caches, prefill graphs against their (cache, T) keys, prefill ms per
    chunk, decode ms per step, B2's launches at start > 0); fails if it
    captured more decode graphs than it had caches or more prefill graphs
    than keys, or if a chunk after a reused prefix ran no B2 at start > 0."""
    perf = eng.perf
    lat = perf.stream_latency()
    if lat is None or not run["chunks"]:
        fail(f"{name}: no chunk ran")
    first, p50, p99 = lat
    L = cfg.dec_layers
    deltas = b2_deltas(run)
    keys = len({(cache, T) for cache, T, _ in run["prefills"]})
    if len(deltas) != perf.reuse_prefills or len(run["prefills"]) != perf.prefills:
        fail(f"{name}: {len(deltas)} prefills at start > 0 of {len(run['prefills'])}, the "
             f"engine counts {perf.reuse_prefills} of {perf.prefills}")
    if DEV == "cuda" and not 1 <= perf.graph_captures <= run["allocs"]:
        fail(f"{name}: {perf.graph_captures} decode graphs captured over {run['allocs']} "
             f"caches (at most one per cache)")
    if perf.prefill_captures > keys:
        fail(f"{name}: {perf.prefill_captures} prefill graphs captured over {keys} "
             f"(cache, T) keys")
    Ts = sorted({T for T, _ in deltas})
    summary = {
        "chunks": len(run["chunks"]), "wall_s": wall_s,
        "realtime_factor": perf.audio_ms / perf.total_ms,
        "chunk_ms_p50": p50, "chunk_ms_p99": p99, "first_commit_ms": first,
        "encode_ms": perf.encode_ms, "prefill_ms": perf.prefill_ms,
        "prefill_ms_per_chunk": perf.prefill_ms / len(run["chunks"]),
        "decode_ms": perf.decode_ms - perf.prefill_ms, "total_ms": perf.total_ms,
        "encodes": perf.encodes, "prefill_rows": run["prefill_total"],
        "reused_rows": run["prefill_reused"],
        "reused_share": run["prefill_reused"] / max(run["prefill_total"], 1),
        "graph_captures": perf.graph_captures, "graph_capture_ms": perf.graph_capture_ms,
        "kv_caches": run["allocs"], "prefill_keys": keys,
        "prefill_captures": perf.prefill_captures,
        "prefill_capture_ms": perf.prefill_capture_ms, "prefill_replays": perf.prefill_replays,
        "decode_steps": perf.decode_steps,
        "wasted_steps": perf.wasted_steps, "decode_ms_per_step": decode_ms_per_step(perf),
        "reuse_prefills": perf.reuse_prefills, "b2_launches_start_gt_0": L * len(deltas),
        "b2_delta_T": {T: L * sum(1 for t, _ in deltas if t == T) for T in Ts},
        "b2_delta_start_range": ([min(st for _, st in deltas), max(st for _, st in deltas)]
                                 if deltas else None),
        "text_tokens": perf.text_tokens,
    }
    STREAM_RUNS[name] = summary
    log(f"  {name}: {json.dumps(summary)}")
    return summary


def prefill_breakdown(eng, w) -> dict:
    """Where a stream chunk's prefill time goes, replayed on the warm engine
    after the run with the last chunk's prompt `w`: the whole
    `prefill_with_reuse` and its two parts -- the embeddings built eagerly,
    the prefill graph's run (copies in, replay, the token out) -- each on
    the host clock, synchronised after every call; then the device time of
    one replay and of the same prefill run eagerly (CUDA events over 50
    calls issued back to back)."""
    import torch

    from smolvision_tpu_torch.runtime.buckets import bucket

    def wall(fn, n: int = 10) -> float:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / n

    total = len(w.ids)
    reused = max(0, min(w.reused, total - 1))
    delta_cap = bucket(total - reused, 64)
    tcap = bucket(max(total, reused + delta_cap), 64)
    with torch.inference_mode():
        whole = wall(lambda: eng.prefill_with_reuse(w.ids, w.audio_block, w.audio_start,
                                                    w.enc_seq_len, w.reused))
        embeds = wall(lambda: eng._embeds(w.ids, tcap, w.audio_block, w.audio_start,
                                          w.enc_seq_len))
        delta = eng._embeds(w.ids, tcap, w.audio_block, w.audio_start,
                            w.enc_seq_len)[reused: reused + delta_cap]
        graph = eng._prefills[delta_cap]
        run = wall(lambda: graph.run(delta, reused, total - reused))
        out = {"T": delta_cap, "start": reused, "prefill_with_reuse_ms": whole,
               "embeds_ms": embeds, "graph_run_ms": run,
               "replay_device_ms": eager_ms(graph.graph.replay),
               "eager_step_ms": eager_ms(graph._step)}
    return out


def run_stream(argv, name: str, cfg, stdin=None, audio: bool = False):
    """One stream through the CLI (launches checked against the engine's
    counts); returns (engine, launches, stdout lines, its record)."""
    with stream_record(audio) as runs:
        eng, launches, lines, wall_s = run_cli(argv, name, stdin)
    check_launches(name, launches, eng, cfg)
    stream_summary(name, eng, runs[-1], cfg, wall_s)
    return eng, launches, lines, runs[-1]


LIVE_FEEDER = """
import sys, time
data = open(sys.argv[1], "rb").read()
step, pause = int(sys.argv[2]), float(sys.argv[3])
for i in range(0, len(data), step):
    sys.stdout.buffer.write(data[i:i + step])
    sys.stdout.buffer.flush()
    time.sleep(pause)
"""


def run_live(argv, name: str, cfg, wav: str):
    """`--stdin --stream` with stdin the read end of a pipe that a feeder
    process fills with `wav`, LIVE_FEED_BYTES at a time with a pause between
    (the stream waits on the audio); the run must reach the feed's EOF.  A
    watchdog ends the script if it has not after LIVE_TIMEOUT_S."""
    import threading

    feeder = subprocess.Popen([sys.executable, "-c", LIVE_FEEDER, wav, str(LIVE_FEED_BYTES),
                               str(LIVE_FEED_PAUSE_S)], stdout=subprocess.PIPE)

    def stuck():
        print(f"chip_smoke: FAIL: {name}: no EOF after {LIVE_TIMEOUT_S} s (deadlock?)",
              file=sys.stderr, flush=True)
        feeder.kill()
        os._exit(1)

    watchdog = threading.Timer(LIVE_TIMEOUT_S, stuck)
    watchdog.start()
    try:
        out = run_stream(argv, name, cfg, stdin=io.TextIOWrapper(feeder.stdout))
    finally:
        watchdog.cancel()
        feeder.stdout.close()
        rc = feeder.wait(timeout=60)
    if rc != 0:
        fail(f"{name}: the feeder exited {rc}")
    return out


def on_off_cache(model_dir: str, wav: str, cfg, base) -> None:
    """--stream --f32 with the encoder window cache ON, then OFF.  Where both
    encode the same span (every chunk up to the first completed window's
    end) their audio rows must be bitwise equal and their chunks' raw tokens
    equal; if every chunk's audio rows are equal, every chunk's tokens and
    the stdout must be.  Past that point the cache joins a window encoded
    from its own span to a re-encoded tail, while OFF encodes the whole span
    at once: a chunk whose audio rows differ must owe it to the log-mel,
    taken per span (reflect-padded edges, a clamp at the span's own maximum
    less 8) in both packages, which is shown on the host; its tokens are
    reported, not held."""
    import numpy as np
    import torch

    from smolvision_tpu_torch.config import HOP_LENGTH, SAMPLE_RATE
    from smolvision_tpu_torch.io.wav import load_wav
    from smolvision_tpu_torch.ops.mel import log_mel

    on = run_stream(base + ["-i", wav, "--f32"], "--stream --f32 (cache on)", cfg, audio=True)
    os.environ["SMOLVISION_STREAM_NO_ENC_CACHE"] = "1"
    try:
        off = run_stream(base + ["-i", wav, "--f32"], "--stream --f32 (cache off)", cfg,
                         audio=True)
    finally:
        del os.environ["SMOLVISION_STREAM_NO_ENC_CACHE"]
    ron, roff = on[3], off[3]
    same = [a.shape == b.shape and torch.equal(a, b) for a, b in zip(ron["audio"], roff["audio"])]
    n_same = same.index(False) if False in same else len(same)
    chunk = int(on[0].stream_chunk_sec * SAMPLE_RATE)
    window = on[0].cfg.enc_n_window_infer * HOP_LENGTH
    one_span = window // chunk          # chunks whose cursor is at most one window
    tok_on = [(c[0], c[2]) for c in ron["chunks"]]
    tok_off = [(c[0], c[2]) for c in roff["chunks"]]
    if len(same) != len(tok_on) or len(tok_on) != len(tok_off):
        fail(f"--stream --f32: {len(tok_on)} chunks with the cache, {len(tok_off)} without")
    if n_same < min(one_span, len(same)):
        fail(f"--stream --f32: audio rows of chunk {n_same} differ ON / OFF, where both "
             f"encode the same span")
    if tok_on[:n_same] != tok_off[:n_same]:
        fail(f"--stream --f32: chunk tokens differ ON / OFF over chunks 0-{n_same - 1}, "
             f"whose audio rows are equal")
    if n_same == len(same):
        if on[2] != off[2]:
            fail("--stream --f32: stdout differs ON / OFF, every chunk's audio rows equal")
        log(f"  --stream --f32: encoder cache ON and OFF equal over all {n_same} chunks "
            f"(audio rows, raw tokens per chunk, stdout)")
        return
    # the first chunk whose audio rows differ: its spans' log-mel, ON against OFF
    x = load_wav(wav)
    cursor = min((n_same + 1) * chunk, len(x))
    full_end = cursor // window * window
    spans = [(a, a + window) for a in range(0, full_end, window)]
    spans += [(full_end, cursor)] if full_end < cursor else []
    mel_on = np.concatenate([log_mel(x[a:b]) for a, b in spans], axis=1)
    mel_off = log_mel(x[:cursor])
    frames = np.nonzero(np.abs(mel_on - mel_off).max(axis=0))[0]
    if mel_on.shape != mel_off.shape or not len(frames):
        fail(f"--stream --f32: audio rows of chunk {n_same} differ ON / OFF with the same "
             f"log-mel")
    rows = ron["audio"][n_same] - roff["audio"][n_same]
    first_tok = next((a[0] for a, b in zip(tok_on, tok_off) if a != b), None)
    log(f"  --stream --f32: encoder cache ON and OFF: chunks 0-{n_same - 1} (both encode one "
        f"span) equal in audio rows and raw tokens; from chunk {n_same} (cursor "
        f"{cursor / SAMPLE_RATE:.0f} s, spans {[(a / SAMPLE_RATE, b / SAMPLE_RATE) for a, b in spans]}) "
        f"the per-span log-mel differs from the whole span's at {len(frames)} of "
        f"{mel_off.shape[1]} frames (first {frames[:6].tolist()}, max "
        f"{float(np.abs(mel_on - mel_off).max()):.4g}), the audio rows by up to "
        f"{float(rows.abs().max()):.4g}; tokens first differ at chunk {first_tok}, stdout "
        f"{'equal' if on[2] == off[2] else 'differs'}")


def phase_stream(model_dir: str, wavs: dict, cfg) -> dict:
    """Phase 9: --stream bf16 (eager and graph steps, `run_path`) and --q8
    on the 60 s clip, --enc-window-sec 2 on 20 s, --f32 with the encoder
    window cache ON and OFF on 16 s (`on_off_cache`), --stdin --stream
    through a pipe, and --profile.  Returns the bf16 graph run's launches
    and record."""
    import glob

    base = ["-d", model_dir, "--stream", "--language", "English"]
    with stream_record() as runs:
        eng, launches, lines, wall_s = run_path(base + ["-i", wavs["stream"]], "--stream", cfg)
    stream_summary("--stream", eng, runs[-1], cfg, wall_s)
    bf16 = runs[-1]
    if DEV == "cuda":
        STREAM_RUNS["--stream"]["prefill_breakdown"] = prefill_breakdown(eng, bf16["last_work"])
        log(f"  --stream prefill of the last chunk, replayed on the warm engine: "
            f"{json.dumps(STREAM_RUNS['--stream']['prefill_breakdown'])}")
    if not "".join(lines).strip():
        fail("--stream: empty transcript")
    log(f"  --stream transcript ({eng.perf.text_tokens} text tokens): {''.join(lines)[:120]}")
    del eng
    run_stream(base + ["-i", wavs["stream"], "--q8"], "--stream --q8", cfg)
    run_stream(base + ["-i", wavs["window"], "--enc-window-sec", "2"],
               "--stream --enc-window-sec 2", cfg)

    on_off_cache(model_dir, wavs["on_off"], cfg, base)

    run_live(["-d", model_dir, "--stdin", "--stream", "--language", "English"],
             "--stdin --stream", cfg, wavs["window"])

    trace_dir = os.path.join(os.path.dirname(wavs["profile"]), "profile")
    run_stream(base + ["-i", wavs["profile"], "--profile", trace_dir], "--stream --profile",
               cfg)
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    if not traces or not os.path.getsize(traces[0]):
        fail(f"--profile: no trace file in {trace_dir}")
    with open(traces[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"  --profile: {traces[0]} ({os.path.getsize(traces[0])} bytes, {len(events)} events, "
        f"{kernels} of them the card's kernels)")
    return {"launches": launches, "record": bf16}


# ---------------------------------------------------------------------------
# phase 10: multistream (--stream with several -i files)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def mstream_record(prompts: bool = False):
    """Records the multistream runs (runtime/multistream.py) the block makes:
    the session engine views in the order they are made (source order);
    per view its chunks (index, reused rows, the tokens and count
    finish_chunk gets, and with `prompts` the chunk's prompt ids and audio
    rows); each session's prefill and reused rows at its end; every B5 call
    as (B, T, start, K).  The wrappers only record."""
    from smolvision_tpu_torch.kernels import flash_attention as fa
    from smolvision_tpu_torch.runtime import multistream, stream

    rec = {"views": [], "chunks": {}, "prefill": {}, "b5": []}
    clone = multistream.clone_session
    finish, final = stream.StreamState.finish_chunk, stream.StreamState.finalize
    b5 = fa.batched_cache_flash_attention

    def rec_clone(engine):
        view = clone(engine)
        rec["views"].append(view)
        return view

    def rec_finish(self, w, chunk_tokens, n_generated, decode_ms):
        entry = {"chunk": self.chunk_idx, "reused": w.reused, "tokens": list(chunk_tokens),
                 "n": n_generated}
        if prompts:
            entry.update(ids=list(w.ids), audio=w.audio_block[: w.enc_seq_len].clone(),
                         audio_start=w.audio_start, n_audio=w.enc_seq_len)
        rec["chunks"].setdefault(id(self.engine), []).append(entry)
        finish(self, w, chunk_tokens, n_generated, decode_ms)

    def rec_final(self):
        rec["prefill"][id(self.engine)] = (self.prefill_total, self.prefill_reused)
        return final(self)

    def rec_b5(q, k_new, v_new, k_cache, v_cache, start_pos, *args, **kwargs):
        rec["b5"].append((q.shape[0], q.shape[1], start_pos, k_cache.shape[2]))
        return b5(q, k_new, v_new, k_cache, v_cache, start_pos, *args, **kwargs)

    with contextlib.ExitStack() as stack:
        for obj, attr, fn in ((multistream, "clone_session", rec_clone),
                              (stream.StreamState, "finish_chunk", rec_finish),
                              (stream.StreamState, "finalize", rec_final),
                              (fa, "batched_cache_flash_attention", rec_b5)):
            stack.enter_context(mock.patch.object(obj, attr, fn))
        yield rec


def session_chunks(rec) -> list:
    """Per session, in source order: (chunk index, tokens, count) per chunk."""
    return [[(e["chunk"], e["tokens"], e["n"]) for e in rec["chunks"].get(id(v), [])]
            for v in rec["views"]]


def check_mstream_launches(name: str, launches: dict, eng, rec, cfg) -> None:
    """Every kernel's launches equal the multistream run's bookkeeping: B1
    once per layer per encoder call (the batched pre-encodes on the engine,
    the sessions' own encodes on their views), B5 once per layer per
    batched round (none on an int8 cache), the greedy head once per round's
    prefill and once per decode step of the round at R = the round's B;
    the single-stream path of the views (the threaded mode, the solo
    fallback): B2 per prefill, B3 per step, the head at R 1."""
    import torch

    from smolvision_tpu_torch.kernels import argmax_matvec as am
    from smolvision_tpu_torch.ops.quant import QuantW

    perf, views = eng.perf, rec["views"]
    L = cfg.dec_layers
    head = eng.dec_params["lm_head"]
    dtype = torch.int8 if isinstance(head, QuantW) else head.dtype
    prefills = sum(v.perf.prefills for v in views)
    steps = sum(v.perf.decode_steps for v in views)
    expected = {k: 0 for k in launches}
    expected.update({
        "window_attention": cfg.enc_layers * (perf.encodes + sum(v.perf.encodes for v in views)),
        "causal_cache_attention": L * prefills, "decode_attention": L * steps,
        "batched_cache_attention": 0 if eng.kv8 else L * perf.delta_prefills})

    def heads(n: int, R: int) -> None:
        if n:
            expected[am.launch_key(am.head_route(R, dtype), dtype)] += n

    heads(prefills + steps, 1)
    for r in (perf.multistream or {}).get("rounds", []):
        heads(1 + r["steps"], r["B"])
    log(f"{name}: launches {json.dumps(launches)}, expected {json.dumps(expected)}")
    if launches != expected:
        fail(f"{name}: launch counts {launches} != expected {expected}")


def percentiles(values) -> list:
    import numpy as np

    return [float(np.percentile(values, 50)), float(np.percentile(values, 99))] if values else None


def mstream_summary(name: str, eng, rec, cfg) -> dict:
    """What a batched multistream run shows: its aggregate realtime factor,
    round ms, the sessions' chunk latency and first commits, the reused
    share of prefill rows, B5's launches at start > 0 by block W and the
    (S, W, pcap) range, compactions, captures against caches, decode ms per
    step at each B.  Fails if it captured more decode graphs than it had
    caches, if a round's block is not the one the reuse rule gives, or if
    B5's launches at start > 0 are not one per layer per such round."""
    from smolvision_tpu_torch.runtime.buckets import bucket
    from smolvision_tpu_torch.runtime.multistream import quantize_block

    perf, views = eng.perf, rec["views"]
    record = perf.multistream
    rounds = record["rounds"] if record else []
    if not rounds:
        fail(f"{name}: no batched round ran")
    if DEV == "cuda" and not 1 <= perf.graph_captures <= record["caches"]:
        fail(f"{name}: {perf.graph_captures} decode graphs captured over {record['caches']} "
             f"caches (at most one per cache)")
    for i, r in enumerate(rounds):
        S = min(r["reused"]) // 64 * 64
        want = quantize_block(S, min(bucket(max(r["lens"]) - S, 64), r["pcap"] - S), r["pcap"])
        if (r["S"], r["W"]) != want:
            fail(f"{name}: round {i} prefilled [{r['S']}, {r['S'] + r['W']}), the reuse rule "
                 f"gives {want} (reused {r['reused']})")
    L = cfg.dec_layers
    deep = [r for r in rounds if r["S"] > 0]
    b5_deep = [b for b in rec["b5"] if b[2] > 0]
    if not eng.kv8 and len(b5_deep) != L * len(deep):
        fail(f"{name}: {len(b5_deep)} B5 calls at start > 0 over {len(deep)} rounds at S > 0")
    chunk_ms = [ms for v in views for ms in v.perf.stream_chunk_ms]
    totals = [rec["prefill"].get(id(v), (0, 0)) for v in views]
    by_b = {}
    for r in rounds:
        ms, steps, n = by_b.get(r["B"], (0.0, 0, 0))
        by_b[r["B"]] = (ms + r["decode_ms"], steps + r["steps"], n + 1)
    summary = {
        "card": CARD_LINE, "sessions": len(views), "audio_s": perf.audio_ms / 1000.0,
        "total_ms": perf.total_ms, "realtime_factor": perf.audio_ms / perf.total_ms,
        "rounds": len(rounds), "round_ms_p50_p99": percentiles([r["wall_ms"] for r in rounds]),
        "round_prefill_ms_p50_p99": percentiles([r["prefill_ms"] for r in rounds]),
        "round_pre_encode_ms_p50_p99": percentiles([r["pre_encode_ms"] for r in rounds]),
        "chunk_ms_p50_p99": percentiles(chunk_ms),
        "first_commit_ms": [v.perf.stream_first_commit_ms for v in views],
        "prefill_rows": sum(t for t, _ in totals), "reused_rows": sum(u for _, u in totals),
        "reused_share": sum(u for _, u in totals) / max(sum(t for t, _ in totals), 1),
        "rounds_at_S_gt_0": len(deep), "share_rounds_at_S_gt_0": len(deep) / len(rounds),
        "b5_launches_start_gt_0": len(b5_deep),
        "b5_start_gt_0_by_W": {W: sum(1 for b in b5_deep if b[1] == W)
                               for W in sorted({b[1] for b in b5_deep})},
        "S_W_pcap_range": ([[min(r[k] for r in deep), max(r[k] for r in deep)]
                            for k in ("S", "W", "pcap")] if deep else None),
        "compactions": record["compactions"], "grows": record["grows"],
        "caches": record["caches"], "graph_captures": perf.graph_captures,
        "graph_capture_ms": perf.graph_capture_ms,
        "decode_ms_per_step_by_B": {B: ms / max(st, 1) for B, (ms, st, _) in sorted(by_b.items())},
        "rounds_by_B": {B: n for B, (_, _, n) in sorted(by_b.items())},
        "decode_steps": perf.batch_decode_steps, "wasted_steps": perf.wasted_steps,
        "encodes": perf.encodes + sum(v.perf.encodes for v in views),
        "text_tokens": sum(v.perf.text_tokens for v in views),
    }
    MSTREAM_RUNS[name] = summary
    log(f"  {name}: {json.dumps(summary)}")
    return summary


def run_mstream(argv, name: str, cfg, turns=("eager", "graph"), prompts: bool = False):
    """One multistream run through the CLI per turn: the decode loops' steps
    run eagerly, then as CUDA graphs (`decode_mode`).  Each turn's launches
    must equal its bookkeeping; the turns' per-session chunk tokens and
    counts, and their decode chunks, must be equal.  Returns the last
    turn's (engine, launches, stdout lines, record)."""
    import gc

    out = {}
    for mode in turns:
        with decode_mode(mode) as drec, mstream_record(prompts) as rec:
            eng, launches, lines, _ = run_cli(argv, f"{name} ({mode})")
        check_mstream_launches(f"{name} ({mode})", launches, eng, rec, cfg)
        out[mode] = (eng, launches, lines, rec, drec)
        if mode != turns[-1]:
            r = eng.perf.multistream["rounds"]
            log(f"  {name} ({mode}): decode ms per step "
                f"{sum(x['decode_ms'] for x in r) / max(sum(x['steps'] for x in r), 1):.2f}, "
                f"realtime factor {eng.perf.audio_ms / eng.perf.total_ms:.2f}x")
            del eng
            out[mode] = out[mode][1:]
            gc.collect()
    eng, launches, lines, rec, drec = out[turns[-1]]
    if len(turns) > 1:
        _, elines, erec, edrec = out[turns[0]]
        if session_chunks(erec) != session_chunks(rec) or elines != lines:
            fail(f"{name}: the sessions' chunk tokens differ between the eager and graph turns")
        if edrec["chunks"] != drec["chunks"]:
            fail(f"{name}: the decode chunks differ between the eager and graph turns")
        log(f"  {name}: eager and graph turns equal over "
            f"{sum(len(c) for c in session_chunks(rec))} session chunks and "
            f"{len(drec['chunks'])} decode chunks")
    if eng.perf.multistream:
        mstream_summary(name, eng, rec, cfg)
    return eng, launches, lines, rec


def solo_streams(eng, clips) -> tuple:
    """Each clip streamed alone, one after another, on session views of the
    warm engine (the single-stream path); (texts, wall seconds)."""
    import torch

    from smolvision_tpu_torch.runtime import multistream, stream

    texts = []
    if DEV == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    for c in clips:
        view = multistream.clone_session(eng)
        view.token_cb = lambda piece: None
        texts.append(stream.transcribe_stream(view, c))
    if DEV == "cuda":
        torch.cuda.synchronize()
    return texts, time.monotonic() - t0


def parting_gap(eng, entry, tokens, i: int) -> tuple:
    """The single-stream path's top-2 logit gap at token i of a chunk whose
    prompt `entry` holds (prefill logits, then the chunk's tokens before i
    fed as decode steps), and the near-tie bound on f32 weights: two paths
    whose logits each differ by at most F32_LOGIT_DIFF (phase 4's reading)
    can order two logits differently only where they lie within twice
    that."""
    import torch

    bound_gap = 2.0 * F32_LOGIT_DIFF
    with torch.inference_mode():
        eng.reset_kv()
        logits, pos = eng.prefill_ids(entry["ids"], entry["audio"], entry["audio_start"],
                                      entry["n_audio"], greedy=False)
        for t in tokens[:i]:
            logits = eng.decode_step(t, pos, greedy=False)
            pos += 1
        top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1]), bound_gap


def f32_against_solo(eng, rec, solo_rec) -> dict:
    """--f32 sessions against their solo runs: per session the first chunk
    whose tokens or count differ; there, the token where they part must be
    a near tie of the single-stream path (`parting_gap` under its bound),
    else it is a fault.  Returns {session: parting or None}."""
    out = {}
    for s, (view, sview) in enumerate(zip(rec["views"], solo_rec["views"])):
        got, want = rec["chunks"][id(view)], solo_rec["chunks"][id(sview)]
        part = next((j for j, (a, b) in enumerate(zip(got, want))
                     if (a["tokens"], a["n"]) != (b["tokens"], b["n"])),
                    None if len(got) == len(want) else min(len(got), len(want)))
        if part is None:
            out[s] = None
            continue
        if part >= min(len(got), len(want)):
            fail(f"--f32 session {s}: {len(got)} chunks batched, {len(want)} solo")
        a, b = got[part], want[part]
        i = next((k for k, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y),
                 min(len(a["tokens"]), len(b["tokens"])))
        gap, bound_gap = parting_gap(eng, b, b["tokens"], i)
        rows = float((a["audio"] - b["audio"]).abs().max()) if a["audio"].shape == \
            b["audio"].shape else None
        out[s] = {"chunk": part, "token": i, "gap": gap, "bound": bound_gap,
                  "audio_rows_max_abs_diff": rows,
                  "audio_rows_max_abs": float(b["audio"].abs().max()),
                  "prompt_equal": a["ids"] == b["ids"]}
        log(f"  --f32 session {s} parts from its solo run at chunk {part}, token {i}: "
            f"top-2 gap {gap:.4g} (bound {bound_gap:.4g}), audio rows differ by {rows} "
            f"(largest {out[s]['audio_rows_max_abs']:.4g})")
        if not gap < bound_gap:
            fail(f"--f32 session {s}: parts from solo at chunk {part}, token {i}, where the "
                 f"top-2 gap {gap:.4g} >= {bound_gap:.4g}")
    return out


def phase_multistream(model_dir: str, wavs, cfg) -> dict:
    """Phase 10: `--stream -i` the MSTREAM_CLIP_SEC clips, bf16 (eager and
    graph turns) against the same clips streamed solo one after another;
    `--q8 --kv8` (graph turn: K7 at R = B, the int8 batched cache through
    the two-part attention, kv_rows_gather on a QuantKV); `--f32` on the
    first MSTREAM_F32_CLIPS clips against their solo runs; the threaded
    mode (SMOLVISION_BATCH_STREAMS=0) on the first MSTREAM_THREADED_CLIPS,
    whose texts must equal the batched run's.  Returns the bf16 graph
    turn's launches and record.  The solo runs read the same WAV files as
    the CLI (16-bit samples)."""
    from smolvision_tpu_torch.io.wav import load_wav

    clips = [load_wav(w) for w in wavs]
    base = ["-d", model_dir, "--stream", "--language", "English"]
    n = len(wavs)
    name = f"--stream x{n}"
    eng, launches, lines, bf16_rec = run_mstream(base + ["-i", *wavs], name, cfg)
    if len(lines) != n or not any(line.strip() for line in lines):
        fail(f"{name}: {len(lines)} transcript lines for {n} clips, or all empty")
    record = eng.perf.multistream
    share = MSTREAM_RUNS[name]["share_rounds_at_S_gt_0"]
    if not share >= MSTREAM_MIN_DEEP_SHARE:
        fail(f"{name}: {MSTREAM_RUNS[name]['rounds_at_S_gt_0']} of {len(record['rounds'])} "
             f"rounds prefilled at start > 0 ({share:.3f}, under {MSTREAM_MIN_DEEP_SHARE}: "
             f"B5's cache half ran too little)")
    b5_runs = [("bf16", str(eng.batched_kv_dtype).replace("torch.", ""), record["rounds"],
                bf16_rec["b5"])]
    if [r["B"] for r in record["rounds"]][:1] != [8] or record["compactions"] < 2:
        fail(f"{name}: rows {sorted({r['B'] for r in record['rounds']})}, "
             f"{record['compactions']} compactions (expected B 8 compacted to 4, then 2)")
    with mstream_record() as solo_rec:
        solo_texts, solo_s = solo_streams(eng, clips)
    equal = [i for i, (a, b) in enumerate(zip(session_chunks(bf16_rec),
                                               session_chunks(solo_rec))) if a == b]
    audio_s = eng.perf.audio_ms / 1000.0
    MSTREAM_RUNS[name].update(
        solo_one_after_another_s=solo_s, solo_realtime_factor=audio_s / solo_s,
        aggregate_speedup=solo_s * 1000.0 / eng.perf.total_ms,
        sessions_equal_to_solo_bf16=equal,
        texts_equal_to_solo_bf16=[i for i in range(n) if lines[i] == solo_texts[i]])
    log(f"  {name} against the same clips streamed solo one after another [{CARD_LINE}]: "
        f"{eng.perf.total_ms / 1000:.2f} s against {solo_s:.2f} s "
        f"({MSTREAM_RUNS[name]['realtime_factor']:.2f}x against {audio_s / solo_s:.2f}x "
        f"realtime); sessions whose chunks equal their solo run on bf16 (reported, not held): "
        f"{equal}")
    del eng

    eng, _, _, _ = run_mstream(base + ["-i", *wavs, "--q8", "--kv8"], f"{name} --q8 --kv8",
                               cfg, turns=("graph",))
    if not (eng.kv8 and eng.q8) or eng.perf.multistream["compactions"] < 1:
        fail(f"{name} --q8 --kv8: kv8 {eng.kv8}, q8 {eng.q8}, "
             f"{eng.perf.multistream['compactions']} compactions of the int8 cache")
    del eng

    k = MSTREAM_F32_CLIPS
    eng, _, f32_lines, rec = run_mstream(base + ["-i", *wavs[:k], "--f32"],
                                         f"--stream x{k} --f32", cfg, turns=("graph",),
                                         prompts=True)
    with mstream_record(prompts=True) as solo_rec:
        solo_f32, _ = solo_streams(eng, clips[:k])
    partings = f32_against_solo(eng, rec, solo_rec)
    log(f"  --stream x{k} --f32 against each clip's solo --stream --f32 run (near-tie bound "
        f"{2.0 * F32_LOGIT_DIFF:.4g}): {json.dumps(partings)}")
    b5_runs.append(("f32", str(eng.batched_kv_dtype).replace("torch.", ""),
                    eng.perf.multistream["rounds"], rec["b5"]))
    del eng

    m = MSTREAM_THREADED_CLIPS
    os.environ["SMOLVISION_BATCH_STREAMS"] = "0"
    try:
        with mstream_record() as trec:
            eng, tlaunches, tlines, _ = run_cli(base + ["-i", *wavs[:m], "--f32"],
                                                f"--stream x{m} --f32 threaded")
    finally:
        del os.environ["SMOLVISION_BATCH_STREAMS"]
    check_mstream_launches(f"--stream x{m} --f32 threaded", tlaunches, eng, trec, cfg)
    if tlines != [t or "" for t in solo_f32[:m]]:
        fail(f"threaded --f32: texts {tlines} differ from the solo runs' {solo_f32[:m]}")
    excused = [s for s in range(m) if partings[s] is not None]
    if any(tlines[s] != f32_lines[s] for s in range(m) if s not in excused):
        fail(f"threaded --f32: texts {tlines} differ from the batched run's {f32_lines[:m]}")
    log(f"  threaded --f32 on {m} clips: texts equal the batched run's (sessions parted at a "
        f"near tie and so excused: {excused}) and the solo runs'; captures per session "
        f"{[v.perf.graph_captures for v in trec['views']]}")
    del eng
    return {"launches": launches, "record": bf16_rec, "b5_runs": b5_runs}


def mstream_b5_table(b5_runs, L: int) -> list:
    """B5 at the rounds at start > 0 of phase 10's runs (label, cache type,
    rounds, the run's B5 calls as (B, T, start, K)).  Each such round's
    shape -- B, S, W, pcap, kcap and its per-row prompt_max, region_start
    = pcap, kv_min 0 -- is checked against the plain version (KERNEL_ATOL)
    on the run's cache type; then one timing row per distinct (run, B, S,
    W, pcap, kcap) at its first round's prompt_max, its launches the run's
    B5 calls at that shape (one per layer per round, else it fails).  SDPA
    gets the same rows as one key sequence per row (the cache's [0, S)
    under prompt_max, then the block, causal, in the cache's type); the
    bound reads q, the fresh K/V and each row's live cache rows once and
    writes the output, and counts the products the masks keep."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=DEV)

    shapes = {}   # (label, B, S, W, pcap, kcap) -> (cache type, [prompt_max per round])
    for label, dtype, rounds, _ in b5_runs:
        for r in rounds:
            if r["S"] > 0:
                key = (label, r["B"], r["S"], r["W"], r["pcap"], r["kcap"])
                shapes.setdefault(key, (dtype, []))[1].append(r["prompt_max"])
    if not shapes:
        fail("multistream: no round at start > 0 to hold B5 at")
    errs, rows, launches = {}, [], []
    for (label, B, S, W, pcap, kcap), (dtype, pms) in shapes.items():
        name = f"batched_cache_attention_mstream_{label}_B{B}_S{S}_W{W}_pcap{pcap}"
        q, kn, vn = batched_case(B, W)
        for pm in pms:
            kc, vc = batched_cache(B, kcap, S, [0] * B, pm, pcap, dtype=dtype)
            args = (q, kn, vn, kc, vc, S, ints([0] * B), ints(pm), pcap)
            err = check_close(f"B5 at a multistream round ({label}): B={B} W={W} S={S} "
                              f"pcap={pcap} kcap={kcap} prompt_max={pm}",
                              fa.batched_cache_flash_attention(*args),
                              fa.batched_cache_attention_plain(*args))
            errs[name] = max(errs.get(name, 0.0), err)
        calls = sum(1 for b in next(run[3] for run in b5_runs if run[0] == label)
                    if b == (B, W, S, kcap))
        if calls != L * len(pms):
            fail(f"{name}: {calls} B5 calls at this shape over {len(pms)} rounds")
        pm = pms[0]
        kc, vc = batched_cache(B, kcap, S, [0] * B, pm, pcap, dtype=dtype)
        args = (q, kn, vn, kc, vc, S, ints([0] * B), ints(pm), pcap)
        H, D = q.shape[2:]
        KH = kn.shape[2]
        live = [min(S, p) for p in pm]
        nbytes = 4 * (2 * q.numel() + 2 * kn.numel()) + kc.element_size() * 2 * KH * D * sum(live)
        flops = 4 * H * D * sum(n + t + 1 for n in live for t in range(W))
        kcat, vcat = (torch.cat([c[:, :, :S], x.to(c.dtype).transpose(1, 2)], dim=2)
                      for c, x in ((kc, kn), (vc, vn)))
        cols = torch.arange(S + W, device=DEV)
        mask = torch.where(cols[None, None, :] < S,
                           cols[None, None, :] < ints(pm)[:, None, None],
                           cols[None, None, :] <= S + torch.arange(W, device=DEV)[None, :, None])
        qh = q.to(kc.dtype).transpose(1, 2)
        rows.append((name, "smolvision_tpu_torch/kernels/csrc/batched_cache_attention.cu",
                     "smolvision_tpu/kernels/flash_attention.py:412",
                     lambda a=args: fa.batched_cache_flash_attention(*a),
                     lambda a=args: fa.batched_cache_attention_plain(*a),
                     lambda q=qh, k=kcat, v=vcat, m=mask[:, None]:
                         F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=True),
                     bound(nbytes, flops, "bfloat16")))
        launches.append(calls)
    log(f"B5 at phase 10's rounds at start > 0 vs plain: max_abs_err {json.dumps(errs)} "
        f"(tolerance {KERNEL_ATOL:g})")
    table = timed_table(rows, errs, {})
    for entry, n in zip(table, launches):
        entry["launches"] = n
    return table


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 only (build, kernels vs plain versions, timings); prints "
                         "the kernels line without launches and no ok line")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "smolvision_tpu_torch")):
        fail(f"no smolvision_tpu_torch/ beside {__file__}: run it from a checkout")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    global CARD_LINE, F32_LOGIT_DIFF
    CARD_LINE = smi_line
    log(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi_line}")

    # phase 2: build
    from smolvision_tpu_torch.kernels import build

    t0 = time.monotonic()
    logs = build.build_all()
    log(f"build: {time.monotonic() - t0:.2f} s ({len(logs)} libraries)")
    for entry in logs:
        for line in entry.ptxas.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{entry.name}] {line.strip()}")
    since("phase 2 (build)")
    for i in range(BUILD_CACHE_CHECKS):
        cache = build_cache_check()
        log(f"build cache, fresh process {i + 1} of {BUILD_CACHE_CHECKS}: loaded "
            f"{len(cache['cached'])} libraries without nvcc in {cache['seconds']:.2f} s; "
            f"probe_mm from the cache vs torch.matmul: max_abs_err "
            f"{cache['probe_mm_max_abs_err']:.3g} (tolerance {PROBE_MM_ATOL:g}), wrong outputs "
            f"{cache['probe_mm_wrong_outputs']} at {cache['probe_mm_first_wrong']}")

    import numpy as np

    from smolvision_tpu_torch.models.synthetic import build as build_checkpoint

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        model_dir = os.path.join(work, "qwen3-asr-0.6b")
        t0 = time.monotonic()
        build_checkpoint("0.6b", model_dir, seed=SEED, dtype="bf16", full_vocab=True)
        samples = speech_like(CLIP_SEC, SEED)
        wav = os.path.join(work, "clip.wav")
        write_wav(wav, samples)
        long_clip = speech_like(SEGMENT_CLIP_SEC, SEED + 1)
        long_wav = os.path.join(work, "long.wav")
        write_wav(long_wav, long_clip)
        serve_clips = [speech_like(sec, SEED + 2 + i) for i, sec in enumerate(SERVE_CLIP_SEC)]
        serve_wavs = [os.path.join(work, f"serve{i}.wav") for i in range(len(serve_clips))]
        for path, c in zip(serve_wavs, serve_clips):
            write_wav(path, c)
        rng = np.random.default_rng(SEED + 100)
        wide_clips = [speech_like(float(sec), SEED + 200 + i)
                      for i, sec in enumerate(2.0 + 4.0 * rng.random(SERVE_WIDE_CLIPS))]
        wide_wavs = [os.path.join(work, f"wide{i}.wav") for i in range(len(wide_clips))]
        for path, c in zip(wide_wavs, wide_clips):
            write_wav(path, c)
        stream_wavs = {}
        for key, sec in (("stream", STREAM_CLIP_SEC), ("window", STREAM_WINDOW_CLIP_SEC),
                         ("on_off", STREAM_ON_OFF_CLIP_SEC), ("profile", STREAM_PROFILE_CLIP_SEC)):
            stream_wavs[key] = os.path.join(work, f"stream_{key}.wav")
            write_wav(stream_wavs[key], speech_like(sec, SEED + 300 + len(stream_wavs)))
        mstream_wavs = [os.path.join(work, f"mstream{i}.wav") for i in range(len(MSTREAM_CLIP_SEC))]
        for i, (path, sec) in enumerate(zip(mstream_wavs, MSTREAM_CLIP_SEC)):
            write_wav(path, speech_like(float(sec), SEED + 400 + i))
        log(f"checkpoint: 0.6b preset, seed {SEED}, bf16, written in "
            f"{time.monotonic() - t0:.2f} s; clip {CLIP_SEC:.0f} s")
        shapes = main_path_shapes(model_dir, samples)
        shapes.update(batched_path_shapes(model_dir, long_clip, serve_clips, wide_clips))
        log(f"attention shapes of the paths: {json.dumps(shapes)}")

        # phase 3: kernels vs plain versions
        from smolvision_tpu_torch.config import detect_config

        cfg = detect_config(model_dir)
        table = phase_kernels(shapes) + phase_heads(cfg, shapes["seg_B"])
        since("phase 3 (kernels)")
        if args.kernels_only:
            print(json.dumps({"kernels": table}))
            print(smi_line)
            return 0

        # phase 4: the main path through the CLI, then kernel vs plain path
        eng, launches = phase_main_path(model_dir, wav, cfg)
        from smolvision_tpu_torch.io.wav import load_wav

        clip = load_wav(wav)
        log(f"  warm third run: {warm_run(eng, clip)}")
        prof = profile_decode(eng, clip)
        DECODE_RUNS["main path"]["profile"] = {k: v for k, v in prof.items() if k != "windows"}
        log(f"decode loop (bf16 main path), eager and graph in turns: {json.dumps(prof)}")
        cmp = compare_paths(eng, clip, steps=MAX_TOKENS // 2)
        log(f"kernel path vs plain path on the card, bf16 weights: {json.dumps(cmp)}")
        del eng
        from smolvision_tpu_torch.runtime.engine import Engine

        eng = Engine(model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                     device=DEV, spec=True)
        eng.set_force_language("English")
        eng.prepare_prompt()
        cmp = compare_paths(eng, clip, steps=MAX_TOKENS // 2)
        log(f"kernel path vs plain path on the card, f32 weights: {json.dumps(cmp)}")
        bcmp = compare_batched_paths(eng, shapes["seg_B"], shapes["seg_T"])
        log(f"batched kernel path vs plain path on the card, f32 weights: {json.dumps(bcmp)}")
        F32_LOGIT_DIFF = max(v["max_abs_err"] for c in (cmp, bcmp) for k, v in c.items()
                             if k.endswith("logits"))
        cmp = spec_vs_plain(eng, clip, MAX_TOKENS, exact=True)
        log(f"--spec vs plain greedy on the card, f32 weights (equal over the whole run): "
            f"{json.dumps(cmp)}")
        del eng

        since("phase 4 (main path)")

        # phase 5: -S 20 on the long clip (batched segments: B1, B4)
        eng, seg_launches = phase_segments(model_dir, long_wav, cfg, shapes["seg_B"],
                                           shapes["seg_T"])
        cmp = compare_batched_paths(eng, shapes["seg_B"], shapes["seg_T"])
        log(f"batched kernel path vs plain path on the card, bf16 weights: {json.dumps(cmp)}")
        del eng

        since("phase 5 (-S 20)")

        # phase 6: --serve over the mixed clips (admission waves: B5)
        eng, serve_launches = phase_serving(model_dir, serve_wavs, cfg, shapes["serve_T"])
        del eng

        since("phase 6 (--serve 4)")

        # phase 7: --q8, --spec, -S 20 --q8 --kv8, --serve 4 --kv8
        int8_runs = phase_int8(model_dir, wav, long_wav, serve_wavs, cfg, shapes)

        since("phase 7 (int8)")

        # phase 8: --serve 64 and --serve 64 --q8 (the heads on the tensor cores)
        wide_runs = phase_serving_wide(model_dir, wide_wavs, cfg, shapes["wide_T"])
        since("phase 8 (--serve 64)")

        # phase 9: --stream, --stdin --stream, --enc-window-sec, --profile
        stream_run = phase_stream(model_dir, stream_wavs, cfg)
        since("phase 9 (--stream)")

        # phase 10: --stream with several -i files (multistream: B1 batched
        # over the sessions' spans, B5 at start > 0, K6 / K7 at R = B)
        mstream_run = phase_multistream(model_dir, mstream_wavs, cfg)
        table += mstream_b5_table(mstream_run["b5_runs"], cfg.dec_layers)
        since("phase 10 (multistream)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # launches: each kernel's count from the path that carries it at the
    # shape its row was timed at
    from smolvision_tpu_torch.kernels import argmax_matvec as am

    seg_head = am.launch_key(am.head_route(shapes["seg_B"], torch.bfloat16), torch.bfloat16)
    launches.update(window_attention_segments=seg_launches["window_attention"],
                    window_attention_wide=wide_runs["bf16"]["window_attention"],
                    decode_attention_long=launches["decode_attention"],
                    batched_causal_attention=seg_launches["batched_causal_attention"],
                    batched_cache_attention=serve_launches["batched_cache_attention"],
                    batched_cache_attention_wide=wide_runs["bf16"]["batched_cache_attention"],
                    argmax_matvec_batched=seg_launches[seg_head],
                    argmax_matvec_q8=int8_runs["--q8"]["argmax_matvec_q8"],
                    argmax_matvec_tc=wide_runs["bf16"]["argmax_matvec_tc"],
                    argmax_matvec_q8_tc=wide_runs["--q8"]["argmax_matvec_q8_tc"],
                    probe_mm=cache["probe_mm_launches"])
    for name, T, _, _ in B2_DELTA_ROWS:   # the bf16 stream's delta prefills of T rows
        launches[name] = cfg.dec_layers * sum(1 for t, _ in b2_deltas(stream_run["record"])
                                              if t == T)
    launches[B2_VERIFY_ROW[0]] = int8_runs["--spec verify"]
    for row in table:
        row.setdefault("launches", launches.get(row["name"]))
        row["kernel_ms"] = row["ms"]
    keys = ("name", "route", "design", "source", "replaces", "launches", "max_abs_err", "ms",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"streams: {json.dumps(STREAM_RUNS)}")
    log(f"multistream [{smi_line}]: {json.dumps(MSTREAM_RUNS)}")
    log(f"decode loops, graph vs eager per path: {json.dumps(DECODE_RUNS)}")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in table]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
