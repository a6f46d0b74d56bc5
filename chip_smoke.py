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
                (T 5, 128 and the main prefill's); B5 with its start a host
                int and an int32 / int64 device tensor (the round prefill
                graph's form), kernel and plain version, at starts 0, 64,
                192, 256, 640 and G 2 / 7 / 3, and one CUDA graph of B5
                replayed at four starts; the greedy heads K6 / K7 on both routes, the
                CUDA-core matvec and the tensor-core tile product, at R 1
                to 130, an exact tie across blocks, V not a multiple of any
                block or tile), then the sweep of R that sets the heads'
                crossover, B3's fixed grid at start 0 (its floor) and the
                sweep of B1's blocks per window, then timings against the plain
                version and one PyTorch library call (B1 at the windows of
                the offline, -S 20 and --serve 64 encode calls, B3 also at
                a 4096-row context, B5 also at --serve 64's admission
                wave, and at the --serve 4 / 16 / 64 waves with start 0
                read from device memory (the wave graph's form, held
                against the plain version and the host int), B2 also on an f32 cache beside SDPA and at the
                stream's delta shapes: start 300, T 128 and 256, checked
                at T 64-512, and at the --spec verify's T 5, start 300, each
                at a device start, against host ints in turns; B5 at
                multistream's round shapes at a device start against host
                ints in turns; K6 and K7 beside cuBLAS + argmax, K7's int8
                table widened to bf16 in the call); K8 (read_all) over
                the lm_head gives the card's read bandwidth, against which
                each head kernel's time is set; then the kernels at phase
                11's Qwen2.5-Omni-7B shapes: B3 at G 7 (H 28, KH 4) at its
                decode start, the cluster plan's edges and long, with a
                graph replayed at four starts; B1 at its 100-token windows
                (H 20, D 64), a one-row last window; B2 at its prefill
                block; K6 over its untied [152064, 3584] head;
  4. main path- a seeded Qwen3-ASR-0.6B checkpoint (full width, random
                weights) transcribes a 20 s synthetic clip through
                `smolvision_tpu_torch.cli`; every kernel's launch count must
                rise by the expected amount; then the card's kernel path is
                held against the card's plain path (encoder output, prefill
                logits, greedy tokens);
  5. segments - `-S 20` on a 120 s clip through the CLI: the device log-mel
                front end (runtime/batch_segments.py `_use_device_mel`: a
                bf16 batch of more than two clips on the card; also in
                phases 6-8, 10 and 12-13 wherever their batches qualify),
                batched encode (B1), batched fresh prefill (B4) and
                batched decode; then
                batched fresh- and delta-prefill logits, kernel path vs
                plain path, in bf16 and f32;
  6. serving  - 8 clips of 4-24 s through `--serve 4`: admission waves
                prefilled by kernel B5 (two waves of one shape, fewer than
                serving.WAVE_GRAPH_MIN_WAVES: eager, the second dispatched
                in the first decode chunk's shadow), slot reuse, TTFT
                percentiles;
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
                then `--serve 16` on the same clips, eager and graph turns:
                four admission waves at one (Gcap, acap) key -- the first
                eager, the second captured, the last two replayed, each
                after the first dispatched in a decode chunk's shadow --
                with equal tokens, exactly one capture, B5's 28 launches
                per wave through the replays, and per wave its dispatch
                host ms, the gap between a chunk's read and the next
                chunk's first replay, the capture ms and the run's rates;
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
 10. multistream - `--stream -i` eight clips of 12-48 s (234 s): one
                round per 2 s chunk for all live sessions, B 8 rows
                compacted to 4, then 2, as sessions end; per round one
                batched encode of the sessions' new spans (B1), one batched
                delta prefill (B5, at start S > 0 with per-row prompt_max
                once every row reuses 64 rows or more; each round's block
                must be the one the reuse rule gives; B5 reads S from
                device memory, a (cache, B, W) key's first two calls
                eager, its third captured as a CUDA graph, later ones
                replayed (the run's first graph warms its capture stream
                with one eager run): each key's calls in that order,
                captures at most the keys,
                every B5 call at a device start, B5's launches measured
                per key) and one batched decode (the head at R = B); the
                round prefill ms split into host preparation, the
                embeddings build, the dispatch, the first tokens' read and
                the device span (CUDA events), eager turn against graph
                turn; against the same clips
                streamed solo one after another (realtime factors);
                `--q8 --kv8` (K7, the int8 batched cache through the
                two-part attention, no B5; compaction gathers a QuantKV);
                `--f32` on three clips against each clip's solo run (a
                parting must be at a near tie of the single-stream path:
                its top-2 gap under twice the largest f32 logit difference
                phase 4 measured between the kernel and plain paths), then
                on the same engine and clips, in process, the stratified
                reset-row prefill (SMOLVISION_MSTREAM_STRAT=1, row 0 forced
                to reuse 0, the JAX package's test settings) against the
                default: equal chunks, stratified rounds > 0; the
                threaded mode (SMOLVISION_BATCH_STREAMS=0) on two, whose
                texts must equal the batched and the solo runs'.  Decode
                graph captures at most the caches (allocation, growths,
                compactions) in every run; at least MSTREAM_MIN_DEEP_SHARE
                of the bf16 run's rounds at S > 0.  Then B5 at each round
                at S > 0 of the bf16 and --f32 runs (its B, S, W, pcap,
                kcap and per-row prompt_max, on the run's cache type, the
                start a host int and a device tensor) against its plain
                version, and timed at a device start once per distinct
                shape, each timing row's launches the run's measured
                launches at that shape (wrapper calls plus replays times
                the graph's launches per replay), which must be one per
                layer per round there.
 11. thinker  - on the 0.6B checkpoint: `--thinker --text` greedy (the
                decode loop's graph, K6) and `--thinker -i` the 20 s clip
                sampled at the defaults (temperature 0.7, top-k 40, penalty
                1.1, seed 0: the first token drawn on the host, the rest
                by one CUDA graph of a sampled step per cache, B3 per
                layer; `runtime/decode_graph.SampleLoop`), each eager then
                as graphs with equal tokens; sampled again to 2048 tokens
                (graph only: B3 to about 2330 rows); `--top-k 1
                --repeat-penalty 1.0` sampled against greedy on --f32
                (equal stdout); `--sampler cref` on 16 tokens (ms per
                token).  Then Qwen2.5-Omni-7B (the q25-7b preset: full
                width and depth, seeded bf16, ~16.5 GB, written by a child
                process while phases 2-10 run; each engine's load timed):
                the 20 s clip with no --thinker (the ASR route: the
                thinker with the default system prompt at temperature 0.7)
                to 512 tokens and `--thinker --temperature 0` to 64 tokens,
                each eager then as graphs with equal tokens, and
                `--thinker --text` sampled; each run's captures at most
                its caches.  Then B1, B2 and B3 at the q25 runs' shapes,
                B3 at the 2048-token run's deepest row and K6 over the q25
                head are timed, each row's launches its run's.
 12. omni     - Qwen3-Omni-30B-A3B (the omni-30b preset: full width, 128
                experts top-8 in every decoder layer, seeded bf16, drawn on
                the card by a child process once phase 11 has deleted
                q25-7b; its decoder cut to OMNI_LAYERS of 48 layers by the
                disk a call may write), resident, loaded once and shared
                by every run: B1, B2, B3, B4 and K6 first checked at its
                shapes (G 8, encoder H 20) while it is written; then
                offline on the 20 s clip, `-S 20` on the 120 s clip (B 6:
                the batched step, dense in its graph), `--stream` on the 20
                s clip (the prefill graphs) and `--thinker --text` sampled,
                each eager then as graphs with equal tokens; the offline
                decode loop profiled; one MoE layer at T 64 with its
                router forced to overflow, captured and eager equal; each
                run's decode ms per step beside its weight-read bound and
                the gather's copied bytes; then int8 experts: `--q8` and
                `--spec` (its int8 draft gathers them inside the
                iteration's graph; its 5-row verify reads every bf16
                expert) offline and `-S 20 --q8` (the dense step over
                the int8 stacks), eager then as graphs, --spec's tokens
                against plain greedy; then, the resident weights freed,
                host offload on the same checkpoint: the link timed by
                one pinned 1 GB copy, `--moe-offload` offline with and
                without `--moe-preload` (tokens against the resident
                run's; per token the router reads, host gather, uploaded
                bytes and their rate, device time by torch.profiler; the
                prefill's whole-stack stream; peak device memory with no
                expert stack on the card) and `--thinker --text
                --moe-offload` sampled twice with one seed (equal); then
                `--spec --f32` on a small untied MoE (tiny-moe's routing
                at card head dims: equal to plain greedy); then the
                kernels timed at its shapes (also B2 at the --spec verify,
                K6 at its R 5, K7 over the int8 head at R 1 and R 6), each
                row's launches its run's.
 13. mesh     - the device mesh (parallel/mesh.py) on torch.distributed:
                world size 1 over nccl, mesh (1, 1), bf16: -S 20's
                segments and --serve 4's clips through shard_engine must
                give the unsharded engine's token rows, graph captures,
                launches per replay and launch counts; then world size 2
                over gloo, two rank processes sharing the card
                (tests/torch_mesh_worker.py, a wall-clock limit that kills
                them), f32 weights: --serve 4 at (dp 2, tp 1), -S 20 and
                --serve 4 at (1, 2) on the 0.6B and --serve 4 with expert
                parallelism at (1, 2) on the small untied MoE; each rank's
                token rows must equal one process's and its launches its
                own bookkeeping at its share, a tp 2 step never captured;
                then B4 and B5 at a tp 2 rank's heads (H 8, KH 4) and K6
                returning keys over a [V / 2, H] vocabulary shard, checked
                and timed.  Times of ranks sharing one card are printed as
                such and are no mesh speed.
 14. front end - run after phase 10: the host runtime library's
                build seconds (utils/native.py, gcc; built in phase 2,
                before anything encodes a prompt); TF32 must be
                off; the device log-mel of -S 20's six segments and of a
                32-clip --serve 64 encode group against the host mel of
                the same f16-rounded audio (FRONTEND_MEL_ATOL); -S 20 bf16
                on the device front end and under SMOLVISION_DEVICE_MEL=0
                (rows may part only at a near tie of the single-clip path,
                phase 7's bf16 bound) with each run's mel ms; mel ms both
                ways, in turns, at the --serve 64 group and over phase 10's
                bf16 rounds (their recorded spans); --sampler cref on 16
                tokens with expf through the library and through ctypes
                (ms per token; equal tokens).
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

Prints the streams', multistream, thinker and 30B runs' summaries, a `{"kernels": [...]}`
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
SERVE_WAVE_SLOTS = 16         # --serve 16 on the wide clips: 4 waves at one wave graph key
SERVE_WAVE_RUN = {}           # phase 8's --serve 16 record
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
MSTREAM_CLIP_SEC = (12, 16, 20, 24, 30, 36, 48, 48)
MSTREAM_F32_CLIPS = 3         # --stream --f32 on the first three clips, against solo
MSTREAM_THREADED_CLIPS = 2    # SMOLVISION_BATCH_STREAMS=0 on the first two
# B5's phase-3 check at a synthetic multistream round: (B, W, S, pcap, kcap,
# per-row prompt_max): a W 128 block at S 256 of a pcap 768 cache.  Its
# checks and timings at the rounds the path runs follow phase 10
# (`mstream_b5_table`)
MSTREAM_B5 = (8, 128, 256, 768, 832, [600 + 14 * b for b in range(8)])
# B5 timed at a device start against host ints (phase 3): the synthetic
# round above and round shapes (B, W, S, pcap, kcap) phase 10's bf16 run
# reaches at S > 0, bf16 cache
MSTREAM_B5_FORMS = ((8, 128, 256, 768, 832), (4, 512, 128, 640, 704), (2, 512, 64, 768, 832))
# the least share of the bf16 multistream run's rounds at S > 0 (B5's cache
# half); 3-6 of 30 rounds in the runs PERF.md records
MSTREAM_MIN_DEEP_SHARE = 0.05
# the largest logit difference between the card's kernel and plain paths on
# f32 weights (phase 4: offline, fresh, served and delta prefill), set there;
# a --f32 multistream session may part from its solo run only where the solo
# path's top-2 gap is under twice this
F32_LOGIT_DIFF = None
# per multistream run (phase 10), printed as one line at the end
MSTREAM_RUNS = {}
# phase 14: the device log-mel (an f32 DFT as products with cos / sin tables)
# against the host's f64 FFT of the same f16 audio, in normalized-mel units:
# ~1e-4 on speech-like clips on the CPU, where the f16 rounding of the audio
# itself moves quiet bins by up to ~0.08; a wrong frame, window or mask
# moves them by O(1)
FRONTEND_MEL_ATOL = 1e-3
# the host runtime library's build in phase 2 (seconds; cached: it was built
# already), reported by phase 14
NATIVE_BUILD = None
CARD_LINE = "not read"        # nvidia-smi's name and power limit, set in phase 1
# phase 11: the thinker on the 0.6B checkpoint, then Qwen2.5-Omni-7B (the
# q25-7b preset: full width and depth, seeded bf16, written by a child
# process while phases 2-10 run)
THINKER_TEXT = "Tell me a long story about the sea, the wind and a small boat."
THINKER_MAX_TOKENS = 128
THINKER_LONG_TOKENS = 2048    # B3 to about 2330 cache rows after the 20 s clip's prompt
THINKER_CREF_TOKENS = 16
Q25_PRESET = "q25-7b"
Q25_ASR_MAX_TOKENS = 512
Q25_GREEDY_MAX_TOKENS = 64
Q25_TEXT_MAX_TOKENS = 256
Q25_HEADS = (28, 4, 128)      # (H, KH, D) of its decoder: G 7
Q25_WINDOW_HEADS = (20, 64)   # (H, D) of its audio tower, at 100-token windows
Q25_BUILD_TIMEOUT_S = 900
# per thinker run (phase 11), printed as one line at the end
THINKER_RUNS = {}
# phase 12: Qwen3-Omni-30B-A3B (the omni-30b preset: full width and depth,
# 48 MoE layers of 128 experts, top-8; seeded bf16, ~62 GB, drawn on the
# card by a child process after phase 11 frees the disk of q25-7b)
OMNI_PRESET = "omni-30b"
# its decoder cut to 16 of 48 layers (config.json): a call on the card may
# write 45 GiB to its disk in all, deleted files included; phases 2-11
# write ~19 GB (the 0.6B and q25-7b checkpoints), the 48-layer checkpoint
# alone is 61.7 GB; 16 layers make 21.9 GB
OMNI_LAYERS = 16
OMNI_HEADS = (32, 4, 128)     # (H, KH, D) of its decoder: G 8
OMNI_WINDOW_HEADS = (20, 64)  # (H, D) of its encoder, at 104-token windows
OMNI_TEXT_MAX_TOKENS = 256
OMNI_OVERFLOW_T = 64          # rows of the forced-overflow forward
OMNI_BUILD_TIMEOUT_S = 600
OMNI_OFFLOAD_THINKER_TOKENS = 32   # --thinker --text --moe-offload (host sampler), twice
OMNI_OFFLOAD_PROFILE_STEPS = 4     # offload decode steps under torch.profiler
# --spec --f32 on an untied full-vocab checkpoint: tiny-moe's routing (4
# experts top-2, 2 layers) at widths the kernels take (head dims 64 in the
# encoder and 128 in the decoder; K7's int8 draft head needs a hidden size
# that is a multiple of 512)
OMNI_TINY_PRESET = "tiny-moe-card"
OMNI_TINY = dict(enc_d=128, enc_L=1, enc_heads=2, enc_ffn=256, enc_out=512, conv_hidden=16,
                 dec_h=512, dec_L=2, dec_heads=4, dec_kv=2, head_dim=128, dec_inter=1024,
                 vocab=151936, moe=dict(num_experts=4, top_k=2, moe_inter=64))
LINK_COPY_BYTES = 1 << 30          # the pinned host-to-device copy that times the link
# per 30B run (phase 12), printed as one line at the end
OMNI_RUNS = {}


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


def decode_row(K: int, start: int, heads=MAIN_HEADS):
    """B3's timing inputs at (K, start) and `heads` (H, KH, D): (kernel,
    plain, SDPA, bound).  The
    kernel reads start from a device tensor, as the decode step passes it.
    SDPA gets the same rows in bf16 with the fresh row written into the
    cache at `start`; the bound reads the live bf16 rows once, q, the fresh
    row and the output in f32."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    q, kn, vn, k, v = decode_case(K, start, *heads)
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


def batched_causal_row(B: int, T: int, pads, heads=MAIN_HEADS):
    """B4's timing inputs at B rows of T with left pads `pads` and `heads`
    (H, KH, D): (source, replaces, kernel, plain, SDPA, bound, f32 CUDA-core
    bound).  The bound reads q, k, v and writes the output in f32 once and
    counts the products the causal and pad masks keep."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    q4, k4, v4 = batched_case(B, T, *heads)
    km4 = torch.tensor(pads, dtype=torch.int32, device=DEV)
    H4, D4 = q4.shape[2:]
    attended = sum(max(t + 1 - lo, 0) for lo in pads for t in range(T))
    nbytes = 4 * (2 * q4.numel() + 2 * k4.numel())
    flops = 4 * H4 * D4 * attended
    ar = torch.arange(T, device=DEV)
    mask4 = ((ar[None, :] <= ar[:, None])[None] & (ar[None, None, :] >= km4[:, None, None]))
    q4h, k4h, v4h = (x.transpose(1, 2) for x in (q4, k4, v4))
    return ("smolvision_tpu_torch/kernels/csrc/batched_causal_attention.cu",
            "smolvision_tpu/kernels/flash_attention.py:286",
            lambda: fa.batched_causal_flash_attention(q4, k4, v4, km4),
            lambda: fa.batched_causal_attention_plain(q4, k4, v4, km4),
            lambda: F.scaled_dot_product_attention(q4h, k4h, v4h, attn_mask=mask4[:, None],
                                                   enable_gqa=True),
            bound(nbytes, flops, "bfloat16"), bound(nbytes, flops, "float32"))


def batched_cache_row(G: int, T: int, lens, heads=MAIN_HEADS, device_start: bool = False):
    """B5's timing inputs at a serving wave's group prefill (start 0: the
    cache is not read) of G rows of T, prompt lengths `lens`, and `heads`
    (H, KH, D): (source, replaces, kernel, plain, SDPA, bound, f32
    CUDA-core bound).  The bound reads q, k, v and writes the output in f32
    once and counts the causal products.  `device_start`: the wave graph's
    form, start 0 an int64 device tensor and region_start a [G] row."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    q5, kn5, vn5 = batched_case(G, T, *heads)
    kc5, vc5 = batched_cache(G, T, 0, [0] * G, KH=heads[1], D=heads[2])
    km5 = torch.zeros(G, dtype=torch.int32, device=DEV)
    pm5 = torch.tensor(lens, dtype=torch.int32, device=DEV)
    attended = G * T * (T + 1) // 2
    nbytes = 4 * (2 * q5.numel() + 2 * kn5.numel())
    flops = 4 * q5.shape[2] * q5.shape[3] * attended
    mask5 = (torch.arange(T, device=DEV)[None, :] <= torch.arange(T, device=DEV)[:, None])
    q5h, k5h, v5h = (x.transpose(1, 2) for x in (q5, kn5, vn5))
    args = (q5, kn5, vn5, kc5, vc5, 0, km5, pm5, 1 << 30)
    if device_start:
        args = args[:5] + (torch.zeros(1, dtype=torch.int64, device=DEV), km5, pm5,
                           torch.full_like(km5, 1 << 30))
    return ("smolvision_tpu_torch/kernels/csrc/batched_cache_attention.cu",
            "smolvision_tpu/kernels/flash_attention.py:412",
            lambda: fa.batched_cache_flash_attention(*args),
            lambda: fa.batched_cache_attention_plain(*args),
            lambda: F.scaled_dot_product_attention(q5h, k5h, v5h, attn_mask=mask5,
                                                   enable_gqa=True),
            bound(nbytes, flops, "bfloat16"), bound(nbytes, flops, "float32"))


def kernel_of(name: str) -> str:
    """The launch key of a timing row: its kernel's name without the suffix
    of the shape it was timed at."""
    for suffix in ("_long", "_wide", "_segments", "_delta128", "_delta256", "_verify", "_q25",
                   "_thinker", "_omni_batched", "_omni", "_tp2", "_wave16", "_wave"):
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
              host_ints: bool = False, heads=MAIN_HEADS):
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

    q, k, v = cache_case(T, K, start, valid, *heads, dtype=dtype)
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
    # the round prefill's device starts 64, 192 and 640 at G 2 / 7 / 3, per-row
    # prompt_max / region_start, a row whose first rows attend nothing
    for start, heads in ((64, MAIN_HEADS), (192, GROUP_HEADS[0]), (640, GROUP_HEADS[1]),
                         (640, MAIN_HEADS)):
        cases.append((3, 64, 768, start, [0, 9, start + 5], [start, start // 2, start - 30],
                      [768, start // 2 + 16, 100], "bfloat16", heads))
    # each with start a host int, then an int32 / int64 device tensor (the
    # round prefill graph's form), through the kernel and the plain version
    for i, (B, T, K, start, kv_min, pm, rs, dtype, (H, KH, D)) in enumerate(cases):
        q, kn, vn = batched_case(B, T, H, KH, D)
        kc, vc = batched_cache(B, K, start, kv_min, pm, rs, KH, D, dtype=dtype)
        args = (q, kn, vn, kc, vc, start, ints(kv_min), None if pm is None else ints(pm),
                rs if rs is None or isinstance(rs, int) else ints(rs))
        at = torch.tensor([start], dtype=(torch.int32, torch.int64)[i % 2], device=DEV)
        dargs = args[:5] + (at,) + args[6:]
        want = fa.batched_cache_attention_plain(*args)
        for form, got in (("host start", fa.batched_cache_flash_attention(*args)),
                          ("device start", fa.batched_cache_flash_attention(*dargs)),
                          ("plain at a device start", fa.batched_cache_attention_plain(*dargs))):
            name = f"B5 B={B} T={T} K={K} start={start} {dtype} H={H} KH={KH} D={D} {form}"
            err = check_close(name, got, want)
            for b, lo in enumerate(kv_min):
                if lo > start and float(got[b, :lo - start].abs().max()) != 0.0:
                    fail(f"{name}: rows of row {b} with no key are not exactly 0")
            errs["batched_cache_attention"] = max(errs["batched_cache_attention"], err)
    # one CUDA graph of B5 at a device start, captured at S 256 of the
    # synthetic round and replayed at other starts by changing its start
    # tensor alone; each replay's cache holds +-999 outside its window
    if DEV == "cuda":
        q, kn, vn = batched_case(Bm, Wm)
        kc, vc = batched_cache(Bm, kcap_m, Sm, [0] * Bm, pm_m, pcap_m)
        at = torch.tensor([Sm], dtype=torch.int64, device=DEV)
        rest = (ints([0] * Bm), ints(pm_m), ints([pcap_m] * Bm))
        fa.batched_cache_flash_attention(q, kn, vn, kc, vc, at, *rest)   # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fa.batched_cache_flash_attention(q, kn, vn, kc, vc, at, *rest)
        for start in (Sm, 0, 64, pcap_m - Wm):
            k2, v2 = batched_cache(Bm, kcap_m, start, [0] * Bm, pm_m, pcap_m)
            kc.copy_(k2)
            vc.copy_(v2)
            at.fill_(start)
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            want = fa.batched_cache_attention_plain(q, kn, vn, kc, vc, start, *rest)
            errs["batched_cache_attention"] = max(
                errs["batched_cache_attention"],
                check_close(f"B5 graph W={Wm} replayed at start {start}", out, want))
        del graph
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
    row = batched_causal_row(B4, T4, pads4)
    rows.append(("batched_causal_attention", *row[:-1]))
    f32_bounds["batched_causal_attention"] = row[-1]

    # --- B5 at serving's group prefill (start 0: the cache is not read),
    # at --serve 4's wave and at --serve 64's (one wave of 64 clips)
    for name, (G, T, lens) in (("batched_cache_attention", (G5, T5, lens5)),
                               ("batched_cache_attention_wide", (GW, TW, lensw))):
        row = batched_cache_row(G, T, lens)
        rows.append((name, *row[:-1]))
        f32_bounds[name] = row[-1]
    # --- B5 at the waves of --serve 4, 16 and 64 as the wave graph runs them
    # (start 0 read from device memory, region_start per row; phases 6 and
    # 8 run the --serve 4 and 64 queues' waves eagerly, too few of one shape
    # to pay a capture back, so those two rows are the graph's form at
    # their shapes and count the eager waves' launches), held against
    # the plain version on the same inputs and against the host-int form;
    # the row's max_abs_err is the larger of the two
    for name, key in (("batched_cache_attention_wave", "serve"),
                      ("batched_cache_attention_wave16", "wave16"),
                      ("batched_cache_attention_wave_wide", "wide")):
        G, T, lens = shapes[f"{key}_G"], shapes[f"{key}_T"], shapes[f"{key}_lens"]
        row = batched_cache_row(G, T, lens, device_start=True)
        got = row[2]()
        errs[name] = max(
            check_close(f"B5 G={G} T={T} at a device start 0 against the plain version",
                        got, row[3]()),
            check_close(f"B5 G={G} T={T} at a device start 0 against the host int",
                        got, batched_cache_row(G, T, lens)[2]()))
        rows.append((name, *row[:-1]))
        f32_bounds[name] = row[-1]

    log(f"  B3 on its fixed grid with no live row (the fresh row alone: the launch, the "
        f"cluster barriers and the merge, the kernel's floor): "
        f"{time_ms(decode_row(K, 0)[0]):.4f} ms")
    log(f"  window split sweep (blocks per (window, head): ms at "
        f"{' / '.join(name for name, _ in WINDOW_ROWS)}; the plan's pick): "
        f"{json.dumps(window_split_sweep(shapes))}")
    log(f"  B2 on an f32 cache: {b2_f32_timings(shapes)}")
    log(f"  B2 with start / kv_valid device tensors against host ints (ms, in turns "
        f"device, host, host, device): {json.dumps(b2_forms)}")
    log(f"  B5 at multistream's round shapes, start a device tensor against a host int "
        f"(ms, in turns device, host, host, device): {json.dumps(b5_device_start_timings())}")

    return timed_table(rows, errs, f32_bounds)


def b5_device_start_timings() -> dict:
    """B5 at each MSTREAM_B5_FORMS round shape (B, W, S, pcap, kcap: a bf16
    cache, per-row prompt_max, region_start = pcap) with its start a device
    tensor (the round prefill graph's form) and a host int, timed in turns
    device, host, host, device; {shape: {form: [ms, ms]}}."""
    import torch

    from smolvision_tpu_torch.kernels import flash_attention as fa

    out = {}
    for B, W, S, pcap, kcap in MSTREAM_B5_FORMS:
        pm = [pcap - 100 + 9 * b for b in range(B)]
        q, kn, vn = batched_case(B, W)
        kc, vc = batched_cache(B, kcap, S, [0] * B, pm, pcap)
        rest = tuple(torch.tensor(x, dtype=torch.int32, device=DEV)
                     for x in ([0] * B, pm, [pcap] * B))
        at = torch.tensor([S], dtype=torch.int64, device=DEV)
        kern = {h: (lambda s=(S if h else at): fa.batched_cache_flash_attention(
                    q, kn, vn, kc, vc, s, *rest)) for h in (False, True)}
        turns = [(h, time_ms(kern[h])) for h in (False, True, True, False)]
        out[f"B {B} W {W} S {S} pcap {pcap}"] = {
            form: [ms for h, ms in turns if h == host]
            for form, host in (("device", False), ("host", True))}
    return out


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


def head_library(h, w, scale=None):
    """The one PyTorch call that computes the greedy head on the same
    inputs: argmax(mm(h, w^T)) with bf16 operands and an f32 result over a
    bf16 table (K6); over an int8 table (K7) the table widened to bf16
    inside the call and the row scales applied to the product."""
    import torch

    hb = h.to(torch.bfloat16)
    if scale is None:
        return lambda: torch.argmax(torch.mm(hb, w.t(), out_dtype=torch.float32), dim=-1)
    return lambda: torch.argmax(torch.mm(hb, w.to(torch.bfloat16).t(),
                                         out_dtype=torch.float32) * scale, dim=-1)


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
    R 64 (the serving width, tensor cores), each beside cuBLAS + argmax
    (`head_library`: for K7 the int8 table widened in the call), and K8
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
        lib = head_library(h, w, scale)
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
        lib_ms = time_ms(r["lib"])
        bound_ms, bound_by = r["bound"]
        table.append({"name": r["name"], "route": "cuda", "source": r["source"],
                      "replaces": r["replaces"], "max_abs_err": r["err"], "ms": min(k1, k2),
                      "plain_ms": min(p1, p2), "library_ms": lib_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "nbytes": r["nbytes"], "design": r["design"],
                      "R": r.get("R")})
        log(f"  {r['name']}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); {r['design']}")
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
    lengths) under --serve 4, --serve 16 and --serve 64, and B1's windows of the
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
            **first_wave(wide_clips, SERVE_WAVE_SLOTS, "wave16"),
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
    key; multistream's round prefill graphs, one per (cache, B, W), apart),
    the kind ("decode", "spec", "sample", "prefill", "delta_prefill") and
    launches per replay of every captured graph (not the graph: it holds
    its owner's cache and weights; serving's wave graphs, one per wave shape,
    apart too), the single-stream caches allocated (the
    first and each growth) and the deepest cache row a single-stream loop
    step wrote."""
    from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
    from smolvision_tpu_torch.runtime import decode_graph

    rec = {"chunks": [], "graphs": [], "reads": 0, "prefill_keys": 0, "delta_prefill_keys": 0,
           "wave_keys": 0, "caches": 0, "last_row": -1}

    def recording(run):
        def recording_run(self, tokens, pos, *args, **kwargs):
            out = run(self, tokens, pos, *args, **kwargs)
            rec["chunks"].append((out[0].tolist(), out[1]))
            if not isinstance(self, decode_graph.DecodeLoop) or self.tok.shape[0] == 1:
                rec["last_row"] = max(rec["last_row"], pos + out[1] - 1)
            return out
        return recording_run

    make_kv = dec_mod.make_kv_cache

    def counting_make_kv(*args, **kwargs):
        rec["caches"] += 1
        return make_kv(*args, **kwargs)

    read = decode_graph._ChunkLoop._read

    def counting_read(*args):
        rec["reads"] += 1
        return read(*args)

    inits = {cls: cls.__init__ for cls in (decode_graph.PrefillGraph,
                                           decode_graph.BatchedPrefillGraph,
                                           decode_graph.WaveGraph)}

    def counting_init(self, *args, **kwargs):
        rec[{"delta_prefill": "delta_prefill_keys", "wave": "wave_keys"}.get(
            self.kind, "prefill_keys")] += 1
        inits[type(self)](self, *args, **kwargs)

    class RecordingGraph(decode_graph.StepGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            rec["graphs"].append((self.kind, self.launches))

    with contextlib.ExitStack() as stack:
        for cls in (decode_graph.DecodeLoop, decode_graph.SpecLoop, decode_graph.SampleLoop):
            stack.enter_context(mock.patch.object(cls, "run", recording(cls.run)))
        stack.enter_context(mock.patch.object(dec_mod, "make_kv_cache", counting_make_kv))
        stack.enter_context(mock.patch.object(decode_graph._ChunkLoop, "_read",
                                              staticmethod(counting_read)))
        for cls in inits:
            stack.enter_context(mock.patch.object(cls, "__init__", counting_init))
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


def replay_launches(eng, cfg, batch: int, wave: int = 0) -> dict:
    """The launches one replay makes, by graph kind: a single-stream decode
    step (batch 0) B3 once per layer and the head once; a --spec iteration
    SPEC_DRAFT int8 steps (B3 per layer, K7 at R 1 each), the verify (B2
    per layer) and its head at R SPEC_DRAFT + 1; a prefill B2 per layer and
    the head at R 1; a batched step the head once at R B (its attention is
    plain torch); a serving wave of `wave` rows B5 per layer (none on an
    int8 cache) and the head at R `wave`; a sampled thinker step B3 once
    per layer and no head."""
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
        if wave:
            out["wave"] = {key(wave): 1, **({} if eng.kv8 else {"batched_cache_attention": L})}
    else:
        out["decode"] = {"decode_attention": L, key(1): 1}
        out["sample"] = {"decode_attention": L}   # the logits and the draw are plain torch
        spec = {"decode_attention": n * L, key(1, torch.int8): n, "causal_cache_attention": L}
        spec[key(n + 1)] = spec.get(key(n + 1), 0) + 1
        out["spec"] = spec
    return out


def decode_ms_per_step(perf) -> float:
    if perf.batch_decode_steps:
        return perf.batch_decode_ms / perf.batch_decode_steps
    return (perf.decode_ms - perf.prefill_ms) / max(perf.decode_steps, 1)


def run_path(argv, name: str, cfg, batch: int = 0, wave: int = 0, loop_kind: str = "",
             turns=("eager", "graph")):
    """One path through the CLI twice, in turns: the decode loops' steps and
    the prefills run eagerly, then as CUDA graphs.  Each run's launches must
    equal its own bookkeeping; the two runs' decoded chunks (tokens and
    counts) must be equal; every graph must launch its step's kernels once
    per replay; the loops read the host once per chunk; the prefill graphs
    captured are at most their (cache, block rows) keys, and a single-stream
    loop's captures at most its caches.  `loop_kind` names the loop's graph
    kind where it is not the path's default ("sample": the sampled
    thinker); `turns` ("graph",) runs the graph turn alone.  Returns the
    graph run's (engine, launches, stdout lines, wall s)."""
    import gc

    import torch

    runs = {}
    for mode in turns:
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with decode_mode(mode) as rec:
            eng, launches, lines, wall_s = run_cli(argv, f"{name} ({mode})")
        check_launches(f"{name} ({mode})", launches, eng, cfg, batch, wave)
        perf = eng.perf
        if rec["reads"] != len(rec["chunks"]):
            fail(f"{name} ({mode}): {rec['reads']} host reads over {len(rec['chunks'])} chunks")
        if perf.prefill_captures > rec["prefill_keys"] + rec["wave_keys"]:
            fail(f"{name} ({mode}): {perf.prefill_captures} prefill graphs captured over "
                 f"{rec['prefill_keys']} (cache, block rows) keys and {rec['wave_keys']} "
                 f"wave shapes")
        if rec["caches"] and perf.graph_captures > rec["caches"]:
            fail(f"{name} ({mode}): {perf.graph_captures} loop graphs captured over "
                 f"{rec['caches']} caches")
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
                      "encode_ms": perf.encode_ms,
                      "loop_decode_ms": perf.decode_ms - perf.prefill_ms,
                      "caches": rec["caches"], "last_row": rec["last_row"],
                      "chunks": len(rec["chunks"]),
                      "max_memory_allocated_gib":
                          torch.cuda.max_memory_allocated() / 2**30 if DEV == "cuda" else 0.0}
        if perf.spec_iters:
            runs[mode].update(spec_iters=perf.spec_iters, spec_tokens=perf.spec_tokens,
                              decode_ms_per_token=(perf.decode_ms - perf.prefill_ms)
                              / perf.spec_tokens)
        if mode == "eager":
            del eng
            gc.collect()
    graph = runs["graph"]
    eager = runs.get("eager", graph)
    if not graph["rec"]["chunks"]:
        fail(f"{name}: no decode chunk ran")
    if graph["rec"]["chunks"] != eager["rec"]["chunks"] or graph["lines"] != eager["lines"]:
        first = next((i for i, (a, b) in enumerate(zip(graph["rec"]["chunks"],
                                                       eager["rec"]["chunks"])) if a != b), None)
        fail(f"{name}: the graph run's decoded chunks differ from the eager run's (first at "
             f"chunk {first} of {len(graph['rec']['chunks'])} / {len(eager['rec']['chunks'])})")
    want = replay_launches(eng, cfg, batch, wave)
    graphs = graph["rec"]["graphs"]
    loop_kind = loop_kind or ("spec" if eng.spec and not batch else "decode")
    if DEV == "cuda" and (not any(k == loop_kind for k, _ in graphs)
                          or any(launched != want.get(k) for k, launched in graphs)):
        fail(f"{name}: launches per replay {graphs}, expected {want}")
    if "eager" in runs and any(launched for _, launched in eager["rec"]["graphs"]):
        fail(f"{name}: an eager step was captured as a graph")
    summary = {"tokens_equal_chunks": len(graph["rec"]["chunks"]) if "eager" in runs else None,
               "launches_per_replay": want[loop_kind],
               "graphs": sum(1 for k, _ in graphs if k not in ("prefill", "wave")),
               "prefill_graphs": sum(1 for k, _ in graphs if k == "prefill"),
               "wave_graphs": sum(1 for k, _ in graphs if k == "wave")}
    for key in ("decode_ms_per_step", "steps", "wasted_steps", "captures", "capture_ms",
                "wall_s", "host_reads", "prefills", "prefill_ms", "prefill_ms_per_call",
                "prefill_keys", "prefill_captures", "prefill_capture_ms", "prefill_replays",
                "realtime_factor", "spec_iters", "spec_tokens", "decode_ms_per_token",
                "encode_ms", "loop_decode_ms", "caches", "last_row", "chunks",
                "max_memory_allocated_gib"):
        if key in graph:
            summary[key] = {mode: runs[mode][key] for mode in turns}
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
    prefill, decode step, verify and batched step (none for the thinker's
    logits prefill and sampled steps) -- int8 (K7) under --q8
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

    # the thinker's sampled prefill and steps give logits: no head
    heads(perf.prefills - perf.logits_prefills, 1, dtype)
    heads(drafts - perf.logits_steps, 1, torch.int8 if eng.spec else dtype)   # --spec: the draft
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
            f"cores {heads} times; mel {perf.mel_ms:.2f} ms (the device front end)")
        runs[extra[0] if extra else "bf16"] = launches
        del eng
    return runs


@contextlib.contextmanager
def serving_wave_record():
    """Yields a list with one record per serving run (`decode_continuous`:
    one per turn of run_path): its admission waves (`PerfStats.
    serving_waves`), latency percentiles, speech seconds and wall seconds,
    and the host gaps between one decode chunk's read and the next chunk's
    first replay (ms)."""
    from smolvision_tpu_torch.runtime import decode_graph, serving

    runs = []
    decode, run, replays = (serving.decode_continuous, decode_graph.DecodeLoop.run,
                            decode_graph._ChunkLoop._replays)

    def recording_decode(engine, clips, *args, **kwargs):
        runs.append({"gaps_ms": [], "read_at": None})
        t0 = time.monotonic()
        rows = decode(engine, clips, *args, **kwargs)
        runs[-1].update(wall_s=time.monotonic() - t0,
                        speech_s=sum(len(c) for c in clips) / 16000,
                        waves=[dict(w) for w in engine.perf.serving_waves],
                        latency=dict(engine.perf.serving_latency),
                        capture_ms=engine.perf.prefill_capture_ms,
                        captures=engine.perf.prefill_captures,
                        replays=engine.perf.prefill_replays)
        return rows

    def timed_replays(self, steps, shadow=None):
        if runs and runs[-1]["read_at"] is not None:
            runs[-1]["gaps_ms"].append((time.monotonic() - runs[-1]["read_at"]) * 1000.0)
        return replays(self, steps, shadow)

    def timed_run(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        if runs:
            runs[-1]["read_at"] = time.monotonic()
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(serving, "decode_continuous", recording_decode))
        stack.enter_context(mock.patch.object(decode_graph._ChunkLoop, "_replays",
                                              timed_replays))
        stack.enter_context(mock.patch.object(decode_graph.DecodeLoop, "run", timed_run))
        yield runs


def phase_serving_waves(model_dir: str, wavs, cfg) -> dict:
    """--serve 16 on the 64 wide clips, eager and graph turns: four
    admission waves of 16 at one (Gcap, acap) key, through the wave graph
    (decode_graph.WaveGraph): the first eager on its capture stream, the
    second captured, the last two replayed, each after the first
    dispatched in a decode chunk's shadow.  The turns' tokens must be
    equal (run_path), the graph turn must capture exactly once and replay
    at least twice, and B5 must count 28 launches per wave through the
    replays (check_launches).  Logs per wave its dispatch host ms, the
    chunk gaps and the capture ms, and the run's rates.  Returns the graph
    run's launches."""
    argv = ["-d", model_dir, "-i", *wavs, "--serve", str(SERVE_WAVE_SLOTS), "--silent",
            "--language", "English", "--max-tokens", str(SERVE_WIDE_MAX_TOKENS)]
    name = f"--serve {SERVE_WAVE_SLOTS} run"
    batch, wave = serving_widths(len(wavs), SERVE_WAVE_SLOTS)
    with serving_wave_record() as runs:
        eng, launches, lines, _ = run_path(argv, name, cfg, batch=batch, wave=wave)
    if len(runs) != 2 or len(lines) != len(wavs):
        fail(f"{name}: {len(runs)} serving runs, {len(lines)} transcript lines for "
             f"{len(wavs)} clips")
    want = [(wave, how, i > 0) for i, how in enumerate(("first", "capture", "replay",
                                                         "replay"))]
    for turn, run in zip(("eager", "graph"), runs):
        got = [(w["rows"], w["how"], w["shadow"]) for w in run["waves"]]
        if got != want:
            fail(f"{name} ({turn}): waves (rows, how, in a chunk's shadow) {got}, expected "
                 f"{want}")
    graph = runs[1]
    replayed = sum(w["how"] == "replay" for w in graph["waves"])
    if graph["captures"] != 1 or replayed < 2:
        fail(f"{name}: {graph['captures']} wave captures (expected 1) and {replayed} replayed "
             f"waves (expected >= 2)")
    L = cfg.dec_layers
    if launches["batched_cache_attention"] != L * len(graph["waves"]):
        fail(f"{name}: B5 launched {launches['batched_cache_attention']} times over "
             f"{len(graph['waves'])} waves (expected {L} per wave)")
    out = {"card": CARD_LINE}
    for turn, run in zip(("eager", "graph"), runs):
        lat = run["latency"]
        out[turn] = {
            "waves": [{k: (round(v, 3) if isinstance(v, float) else v) for k, v in w.items()}
                      for w in run["waves"]],
            "chunk_gaps_ms": [round(g, 3) for g in run["gaps_ms"]],
            "wall_s": round(run["wall_s"], 3),
            "speech_s_per_s": round(run["speech_s"] / run["wall_s"], 2),
            "admit_ttft_p50_ms": lat["admit_ttft_p50_ms"],
            "admit_ttft_p99_ms": lat["admit_ttft_p99_ms"],
            "done_p50_ms": lat["done_p50_ms"], "done_p99_ms": lat["done_p99_ms"],
            "wave_captures": run["captures"], "wave_capture_ms": round(run["capture_ms"], 3),
            "wave_replays": run["replays"]}
    SERVE_WAVE_RUN.update(out)
    log(f"  {name} [{CARD_LINE}]: {json.dumps(out)}")
    return launches


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
    the wrapper sees as (B, T, S, K, device start?, inside a round
    prefill?), S the round prefill's where the start is a device tensor
    (its eager calls, a graph's warm run and its capture; a replay makes
    no wrapper call); per round prefill (`multistream._round_prefill`) its
    key (B, S, W, K) and, where it replayed a graph, the B5 launches per
    replay that graph recorded at its capture (`b5_replayed`); on the card
    a pair of CUDA events around every round prefill.  The wrappers only
    record."""
    import torch

    from smolvision_tpu_torch.kernels import flash_attention as fa
    from smolvision_tpu_torch.runtime import multistream, stream

    rec = {"views": [], "chunks": {}, "prefill": {}, "b5": [], "prefill_events": [],
           "b5_replayed": [], "round": None}
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
        device = isinstance(start_pos, torch.Tensor)
        S = rec["round"][1] if device and rec["round"] else start_pos
        rec["b5"].append((q.shape[0], q.shape[1], S, k_cache.shape[2], device,
                          rec["round"] is not None))
        return b5(q, k_new, v_new, k_cache, v_cache, start_pos, *args, **kwargs)

    round_prefill = multistream._round_prefill

    def rec_round(engine, cache, embeds_blk, S, *args):
        kv = cache.kv
        key = (embeds_blk.shape[0], S, embeds_blk.shape[1],
               kv.shape[4] if isinstance(kv, torch.Tensor) else None)
        rec["round"] = key
        pair = None
        if DEV == "cuda":
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
        try:
            first, how = round_prefill(engine, cache, embeds_blk, S, *args)
        finally:
            rec["round"] = None
        if pair is not None:
            pair[1].record()
            rec["prefill_events"].append(pair)
        if how == "replay":
            graph = cache.prefills[key[2]].graph
            rec["b5_replayed"].append((key, graph.launches.get("batched_cache_attention", 0)))
        return first, how

    with contextlib.ExitStack() as stack:
        for obj, attr, fn in ((multistream, "clone_session", rec_clone),
                              (stream.StreamState, "finish_chunk", rec_finish),
                              (stream.StreamState, "finalize", rec_final),
                              (fa, "batched_cache_flash_attention", rec_b5),
                              (multistream, "_round_prefill", rec_round)):
            stack.enter_context(mock.patch.object(obj, attr, fn))
        yield rec


def session_chunks(rec) -> list:
    """Per session, in source order: (chunk index, tokens, count) per chunk."""
    return [[(e["chunk"], e["tokens"], e["n"]) for e in rec["chunks"].get(id(v), [])]
            for v in rec["views"]]


def b5_round_launches(rec) -> dict:
    """B5's launches in a multistream run's round prefills, measured by
    round key (B, S, W, K): the wrapper's calls inside round prefills at
    that key (eager calls, a graph's warm run, its capture) plus, per
    replay at that key, the B5 launches its graph recorded per replay."""
    out = {}
    for B, T, S, K, _, in_round in rec["b5"]:
        if in_round:
            out[(B, S, T, K)] = out.get((B, S, T, K), 0) + 1
    for key, n in rec["b5_replayed"]:
        out[key] = out.get(key, 0) + n
    return out


def check_mstream_launches(name: str, launches: dict, eng, rec, cfg) -> None:
    """Every kernel's launches equal the multistream run's bookkeeping: B1
    once per layer per encoder call (the batched pre-encodes on the engine,
    the sessions' own encodes on their views), B5 once per layer per
    batched round (none on an int8 cache), the greedy head once per round's
    prefill and once per decode step of the round at R = the round's B
    (and, where a round ran the stratified prefill, B5 per layer and the
    head once more at R = its Gcap);
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
        if r["strat_rows"]:   # the stratified prefill: B5 and the head at R Gcap
            expected["batched_cache_attention"] += 0 if eng.kv8 else L
            heads(1, 1 << (len(r["strat_rows"]) - 1).bit_length())
    log(f"{name}: launches {json.dumps(launches)}, expected {json.dumps(expected)}")
    if launches != expected:
        fail(f"{name}: launch counts {launches} != expected {expected}")


def percentiles(values) -> list:
    import numpy as np

    return [float(np.percentile(values, 50)), float(np.percentile(values, 99))] if values else None


def prefill_split(rounds, rec) -> dict:
    """A multistream run's round prefill ms (p50, p99), by how it ran
    ([rounds, p50 ms] for its eager calls, a graph's warm run, its capture,
    its replays: each round's `prefill_call`), and the p50 of its parts:
    host preparation, the embeddings build and slice, the prefill's
    dispatch, the first tokens' read (host ms, each round's
    `prefill_split_ms`), and on the card the prefill's device span between
    CUDA events around the round prefill (eagerly, the span of its
    launches; replayed, the graph's device time)."""
    import torch

    parts = list(zip(*[r["prefill_split_ms"] for r in rounds]))
    out = {"round_prefill_ms_p50_p99": percentiles([r["prefill_ms"] for r in rounds])}
    by = {}
    for r in rounds:
        by.setdefault(r["prefill_call"], []).append(r["prefill_ms"])
    out["round_prefill_ms_p50_by_call"] = {k: [len(v), percentiles(v)[0]]
                                          for k, v in sorted(by.items())}
    for part, values in zip(("prep", "embeds", "dispatch", "first_token_read"), parts):
        out[f"round_prefill_{part}_ms_p50"] = percentiles(values)[0]
    if rec["prefill_events"]:
        torch.cuda.synchronize()
        out["round_prefill_device_ms_p50_p99"] = percentiles(
            [a.elapsed_time(b) for a, b in rec["prefill_events"]])
    return out


def mstream_summary(name: str, eng, rec, cfg) -> dict:
    """What a batched multistream run shows: its aggregate realtime factor,
    round ms, the round prefill and its parts (`prefill_split`), the
    sessions' chunk latency and first commits, the reused share of prefill
    rows, B5's launches at start > 0 by block W and the (S, W, pcap)
    range, compactions, decode and round prefill graphs captured against
    caches, decode ms per step at each B.  Fails if it captured more decode
    graphs than it had caches, if a round's block is not the one the reuse
    rule gives (S following the rows above 64 where a round stratified), if
    a B5 call of the round prefill took its start from the host, or if
    B5's measured launches at start > 0 (`b5_round_launches`) are not one
    per layer per such round (none on an int8 cache)."""
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
        S = min(x for x in r["reused"] if x >= 64 or not r["strat_rows"]) // 64 * 64
        want = quantize_block(S, min(bucket(max(r["lens"]) - S, 64), r["pcap"] - S), r["pcap"])
        if (r["S"], r["W"]) != want:
            fail(f"{name}: round {i} prefilled [{r['S']}, {r['S'] + r['W']}), the reuse rule "
                 f"gives {want} (reused {r['reused']})")
    L = cfg.dec_layers
    deep = [r for r in rounds if r["S"] > 0]
    host = [b for b in rec["b5"] if b[5] and not b[4]]
    if host:
        fail(f"{name}: {len(host)} B5 calls of the round prefill at a host start: {host[:4]}")
    b5_deep = {k: n for k, n in b5_round_launches(rec).items() if k[1] > 0}
    want = 0 if eng.kv8 else L * len(deep)
    if sum(b5_deep.values()) != want:
        fail(f"{name}: {sum(b5_deep.values())} B5 launches at start > 0 measured over "
             f"{len(deep)} rounds at S > 0 (expected {want})")
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
        **prefill_split(rounds, rec),
        "round_pre_encode_ms_p50_p99": percentiles([r["pre_encode_ms"] for r in rounds]),
        "chunk_ms_p50_p99": percentiles(chunk_ms),
        "first_commit_ms": [v.perf.stream_first_commit_ms for v in views],
        "prefill_rows": sum(t for t, _ in totals), "reused_rows": sum(u for _, u in totals),
        "reused_share": sum(u for _, u in totals) / max(sum(t for t, _ in totals), 1),
        "rounds_at_S_gt_0": len(deep), "share_rounds_at_S_gt_0": len(deep) / len(rounds),
        "b5_launches_start_gt_0": sum(b5_deep.values()),
        "b5_start_gt_0_by_W": {W: sum(n for k, n in b5_deep.items() if k[2] == W)
                               for W in sorted({k[2] for k in b5_deep})},
        "S_W_pcap_range": ([[min(r[k] for r in deep), max(r[k] for r in deep)]
                            for k in ("S", "W", "pcap")] if deep else None),
        "compactions": record["compactions"], "grows": record["grows"],
        "caches": record["caches"], "graph_captures": perf.graph_captures,
        "graph_capture_ms": perf.graph_capture_ms,
        "round_prefill_captures": perf.prefill_captures,
        "round_prefill_capture_ms": perf.prefill_capture_ms,
        "round_prefill_replays": perf.prefill_replays,
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
    and the round prefills run eagerly, then as CUDA graphs (`decode_mode`).
    Each turn's launches must equal its bookkeeping; in a graph turn the
    round prefill graphs captured must be at most their (cache, B, W) keys,
    each launching B5 once per layer (none on an int8 cache) and the head
    once per replay; the turns' per-session chunk tokens and counts, and
    their decode chunks, must be equal, and their round prefill ms and its
    parts are printed side by side.  Returns the last turn's (engine,
    launches, stdout lines, record)."""
    import gc

    out, splits = {}, {}
    for mode in turns:
        with decode_mode(mode) as drec, mstream_record(prompts) as rec:
            eng, launches, lines, _ = run_cli(argv, f"{name} ({mode})")
        check_mstream_launches(f"{name} ({mode})", launches, eng, rec, cfg)
        if mode == "graph" and DEV == "cuda":
            check_prefill_graphs(f"{name} ({mode})", eng, drec, cfg)
        out[mode] = (eng, launches, lines, rec, drec)
        splits[mode] = prefill_split(eng.perf.multistream["rounds"], rec)
        if mode != turns[-1]:
            r = eng.perf.multistream["rounds"]
            log(f"  {name} ({mode}): decode ms per step "
                f"{sum(x['decode_ms'] for x in r) / max(sum(x['steps'] for x in r), 1):.2f}, "
                f"realtime factor {eng.perf.audio_ms / eng.perf.total_ms:.2f}x, "
                f"round prefill {json.dumps(splits[mode])}")
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
            f"{len(drec['chunks'])} decode chunks; round prefill by turn [{CARD_LINE}]: "
            f"{json.dumps(splits)}")
    if eng.perf.multistream:
        mstream_summary(name, eng, rec, cfg)
        MSTREAM_RUNS[name]["round_prefill_by_turn"] = splits
    return eng, launches, lines, rec


def check_prefill_graphs(name: str, eng, drec, cfg) -> None:
    """A graph turn's round prefill graphs: each (cache, B, W) key's calls
    in order (a cache is one (B, kcap): growth raises kcap, compaction
    halves B) run as `multistream._round_prefill` says -- eager before its
    PREFILL_GRAPH_CALL-th call (the one before it a warm run on the capture
    stream for the run's first graph alone), captured at that call, then
    replayed --, captured at most once per key, the captures and replays
    those PerfStats counts, each replay launching B5 once per layer (none
    on an int8 cache) and one greedy head."""
    from smolvision_tpu_torch.runtime.multistream import PREFILL_GRAPH_CALL

    perf, keys = eng.perf, drec["delta_prefill_keys"]
    rounds = perf.multistream["rounds"]
    if not perf.prefill_captures <= keys:
        fail(f"{name}: {perf.prefill_captures} round prefill graphs captured over {keys} "
             f"(cache, B, W) keys")
    calls = {}
    for r in rounds:
        calls.setdefault((r["B"], r["kcap"], r["W"]), []).append(r["prefill_call"])
    warmed = [key for key, seq in calls.items() if "warm" in seq]
    if len(warmed) > 1:
        fail(f"{name}: round prefill keys {warmed} each warmed the capture stream")
    for key, seq in calls.items():
        w = int(key in warmed)
        want = ["eager"] * (PREFILL_GRAPH_CALL - 1 - w) + ["warm"] * w + ["capture"]
        want = (want + ["replay"] * len(seq))[: len(seq)]
        if seq != want:
            fail(f"{name}: round prefill key (B, kcap, W) {key} ran {seq}, expected {want}")
    # PerfStats counts a capture's own replay as a replay
    kinds = [r["prefill_call"] for r in rounds]
    captured, replayed = kinds.count("capture"), kinds.count("replay")
    if (captured, captured + replayed) != (perf.prefill_captures, perf.prefill_replays):
        fail(f"{name}: rounds {captured} captured, {replayed} replayed; PerfStats "
             f"{perf.prefill_captures} captures / {perf.prefill_replays} replays")
    b5 = "batched_cache_attention"
    for kind, launches in drec["graphs"]:
        if kind != "delta_prefill":
            continue
        heads = {k: n for k, n in launches.items() if k != b5}
        if launches.get(b5, 0) != (0 if eng.kv8 else cfg.dec_layers) or \
                list(heads.values()) != [1] or not next(iter(heads)).startswith("argmax"):
            fail(f"{name}: a round prefill graph launches {launches} per replay")


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
    first MSTREAM_F32_CLIPS clips against their solo runs, then on them the
    forced stratified reset-row prefill against the default
    (`strat_against_default`); the threaded
    mode (SMOLVISION_BATCH_STREAMS=0) on the first MSTREAM_THREADED_CLIPS,
    whose texts must equal the batched run's.  Returns the bf16 graph
    turn's launches and record.  The solo runs read the same WAV files as
    the CLI (16-bit samples)."""
    from smolvision_tpu_torch.io.wav import load_wav

    from smolvision_tpu_torch.runtime import multistream

    clips = [load_wav(w) for w in wavs]
    base = ["-d", model_dir, "--stream", "--language", "English"]
    n = len(wavs)
    name = f"--stream x{n}"
    # each round's pre-encoded spans (the device front end's groups), both
    # turns: phase 14 times the front end over the graph turn's rounds
    calls = []
    real = multistream._encode_batch_device_mel
    with mock.patch.object(multistream, "_encode_batch_device_mel",
                           lambda e, spans, *a: calls.append(list(spans)) or real(e, spans, *a)):
        eng, launches, lines, bf16_rec = run_mstream(base + ["-i", *wavs], name, cfg)
    if DEV == "cuda" and not eng.perf.prefill_replays:
        fail(f"{name}: no round prefill replayed a graph")
    mel_rounds = calls[len(calls) // 2:]
    if not mel_rounds or [len(g) for g in calls[: len(calls) // 2]] != [len(g) for g in mel_rounds]:
        fail(f"{name}: the device front end pre-encoded {[len(g) for g in calls]} spans per "
             f"round over the eager and graph turns (expected the same rounds in both)")
    MSTREAM_RUNS[name]["mel_ms"] = eng.perf.mel_ms
    MSTREAM_RUNS[name]["device_mel_rounds"] = len(mel_rounds)
    if len(lines) != n or not any(line.strip() for line in lines):
        fail(f"{name}: {len(lines)} transcript lines for {n} clips, or all empty")
    record = eng.perf.multistream
    share = MSTREAM_RUNS[name]["share_rounds_at_S_gt_0"]
    if not share >= MSTREAM_MIN_DEEP_SHARE:
        fail(f"{name}: {MSTREAM_RUNS[name]['rounds_at_S_gt_0']} of {len(record['rounds'])} "
             f"rounds prefilled at start > 0 ({share:.3f}, under {MSTREAM_MIN_DEEP_SHARE}: "
             f"B5's cache half ran too little)")
    b5_runs = [("bf16", str(eng.batched_kv_dtype).replace("torch.", ""), record["rounds"],
                b5_round_launches(bf16_rec))]
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
                    eng.perf.multistream["rounds"], b5_round_launches(rec)))
    MSTREAM_RUNS["forced stratified --f32"] = strat_against_default(eng, clips[:k], cfg)
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
    return {"launches": launches, "record": bf16_rec, "b5_runs": b5_runs,
            "mel_rounds": mel_rounds}


def strat_against_default(eng, clips, cfg) -> dict:
    """The stratified reset-row prefill (SMOLVISION_MSTREAM_STRAT=1) on the
    warm engine, in process, as the JAX package's test sets it: prompts
    append-only (no past-text conditioning), the recovery resets off,
    MSTRAT_MIN_S 64, MSTRAT_MIN_ACTIVE 2.  A default run, then one with row
    0 forced to reuse 0 (MSTRAT_TEST_FORCE_RESET {0}) and the stratified
    prefill on: equal session chunks, `_strat_round_count` > 0, each run's
    launches its bookkeeping (the stratified rounds' B5 and head at R
    Gcap included)."""
    from smolvision_tpu_torch.kernels import ffi
    from smolvision_tpu_torch.runtime import multistream, stream

    t0 = time.monotonic()
    runs = {}
    with contextlib.ExitStack() as stack:
        for attr in ("DEGEN_MIN_REPEATS", "STALE_CHUNKS", "MAX_REPEAT_TOKEN_RUN"):
            stack.enter_context(mock.patch.object(stream, attr, 1 << 30))
        stack.enter_context(mock.patch.object(multistream, "MSTRAT_MIN_S", 64))
        stack.enter_context(mock.patch.object(multistream, "MSTRAT_MIN_ACTIVE", 2))
        stack.enter_context(mock.patch.object(eng, "past_text_conditioning", False))
        for arm, force, env in (("default", frozenset(), {}),
                                ("forced strat", frozenset({0}),
                                 {"SMOLVISION_MSTREAM_STRAT": "1"})):
            eng.perf.reset()
            eng._strat_round_count = 0
            with mock.patch.object(multistream, "MSTRAT_TEST_FORCE_RESET", force), \
                    mock.patch.dict(os.environ, env), mstream_record() as rec:
                ffi.reset_launch_counts()
                multistream.run_streams_batched(eng, clips)
                launches = dict(ffi.launch_counts)
            check_mstream_launches(f"multistream {arm}", launches, eng, rec, cfg)
            rounds = eng.perf.multistream["rounds"]
            runs[arm] = {"chunks": session_chunks(rec), "strat_rounds": eng._strat_round_count,
                         "rounds": len(rounds),
                         "S": [r["S"] for r in rounds],
                         "strat_rows": [r["strat_rows"] for r in rounds if r["strat_rows"]]}
    out = {"card": CARD_LINE, "clips": len(clips), "seconds": time.monotonic() - t0,
           **{arm: {k: v for k, v in r.items() if k != "chunks"} for arm, r in runs.items()}}
    log(f"  forced stratified run against the default on {len(clips)} clips: {json.dumps(out)}")
    if runs["forced strat"]["strat_rounds"] <= 0:
        fail("the forced stratified run never stratified a round")
    if runs["forced strat"]["chunks"] != runs["default"]["chunks"]:
        fail("the forced stratified run's session chunks differ from the default run's")
    return out


def mstream_b5_table(b5_runs, L: int) -> list:
    """B5 at the rounds at start > 0 of phase 10's runs (label, cache type,
    rounds, the run's measured B5 launches by round key (B, S, W, K):
    `b5_round_launches`).  Each such round's shape -- B, S, W, pcap, kcap
    and its per-row prompt_max, region_start = pcap, kv_min 0 -- is checked
    against the plain version (KERNEL_ATOL) on the run's cache type, with S
    a host int and a device tensor (the round prefill's form); then one
    timing row per distinct (run, B, S, W, pcap, kcap) at its first round's
    prompt_max, at a device start, its launches the run's measured B5
    launches at (B, S, W, kcap), which must be one per layer per round at
    that shape (pcap apart: rounds that share a cache share a kcap).
    SDPA gets the same rows as one key sequence per row (the cache's [0, S)
    under prompt_max, then the block, causal, in the cache's type); the
    bound reads q, the fresh K/V and each row's live cache rows once and
    writes the output, and counts the products the masks keep."""
    import torch
    import torch.nn.functional as F

    from smolvision_tpu_torch.kernels import flash_attention as fa

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=DEV)

    shapes = {}   # (label, B, S, W, pcap, kcap) -> (cache type, [prompt_max per round])
    measured = {label: counts for label, _, _, counts in b5_runs}
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
        at = torch.tensor([S], dtype=torch.int64, device=DEV)
        for pm in pms:
            kc, vc = batched_cache(B, kcap, S, [0] * B, pm, pcap, dtype=dtype)
            rest = (ints([0] * B), ints(pm), pcap)
            want = fa.batched_cache_attention_plain(q, kn, vn, kc, vc, S, *rest)
            for start in (S, at):
                err = check_close(f"B5 at a multistream round ({label}): B={B} W={W} S={S} "
                                  f"pcap={pcap} kcap={kcap} prompt_max={pm} "
                                  f"{type(start).__name__} start",
                                  fa.batched_cache_flash_attention(q, kn, vn, kc, vc, start,
                                                                   *rest), want)
                errs[name] = max(errs.get(name, 0.0), err)
        rounds_at = sum(len(p) for (lb, b, s, w, _, kc), (_, p) in shapes.items()
                        if (lb, b, s, w, kc) == (label, B, S, W, kcap))
        calls = measured[label].get((B, S, W, kcap), 0)
        if calls != L * rounds_at:
            fail(f"{name}: {calls} B5 launches measured at (B, S, W, kcap) over {rounds_at} "
                 f"rounds at that shape (expected {L * rounds_at})")
        pm = pms[0]
        kc, vc = batched_cache(B, kcap, S, [0] * B, pm, pcap, dtype=dtype)
        args = (q, kn, vn, kc, vc, at, ints([0] * B), ints(pm), ints([pcap] * B))
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



# ---------------------------------------------------------------------------
# phase 14: the front end (device log-mel, the host runtime library); runs
# after phase 10, whose multistream rounds it replays
# ---------------------------------------------------------------------------

def frontend_mel_error(eng, clips) -> dict:
    """The device log-mel (`_upload_audio` + `log_mel_batch` on the card) of
    `clips` as one group against the host mel of the same f16-rounded audio
    (the f16 pack is the route's own rounding), max abs over each clip's
    valid columns; also against the host mel of the f32 audio (reported)."""
    import numpy as np
    import torch

    from smolvision_tpu_torch.ops.mel import log_mel, log_mel_batch
    from smolvision_tpu_torch.runtime import batch_segments as bs

    with torch.inference_mode():
        up = bs._upload_audio(eng, clips)
        mel = log_mel_batch(up.buf, torch.tensor(up.frames, device=eng.device),
                            up.fcap).cpu().numpy()
    err = err_f32 = 0.0
    for b, (c, f) in enumerate(zip(clips, up.frames)):
        host = log_mel(np.asarray(c, np.float32).astype(np.float16).astype(np.float32))
        err = max(err, float(np.abs(mel[b, :, :f] - host).max()))
        err_f32 = max(err_f32, float(np.abs(mel[b, :, :f] - log_mel(c)).max()))
    return {"clips": len(clips), "frames_cap": up.fcap, "max_abs_err": err,
            "max_abs_err_vs_f32_audio": err_f32}


def frontend_ms(eng, groups) -> dict:
    """Host ms of the front end over `groups` (lists of clips), each group
    both ways in turns (host, device, device, host): the host mel one clip
    after another, as serving's groups and multistream's rounds run it, and
    the device route's pack, upload and log-mel, synchronised."""
    import torch

    from smolvision_tpu_torch.ops.mel import log_mel, log_mel_batch
    from smolvision_tpu_torch.runtime import batch_segments as bs

    def host(clips):
        for c in clips:
            log_mel(c)

    def device(clips):
        with torch.inference_mode():
            up = bs._upload_audio(eng, clips)
            log_mel_batch(up.buf, torch.tensor(up.frames, device=eng.device), up.fcap)
        if DEV == "cuda":
            torch.cuda.synchronize()

    ms = {"host": [0.0, 0.0], "device": [0.0, 0.0]}
    device(groups[0])   # the first call's one-time work (tables, allocator)
    for turn, way in enumerate(("host", "device", "device", "host")):
        fn = host if way == "host" else device
        t0 = time.monotonic()
        for g in groups:
            fn(g)
        ms[way][turn in (2, 3)] = (time.monotonic() - t0) * 1000.0
    return {"groups": len(groups), "clips": sum(len(g) for g in groups),
            "host_mel_ms": ms["host"], "device_mel_ms": ms["device"]}


def segments_both_ways(eng, segs) -> dict:
    """-S 20's segments through decode_segments_batched on the device
    front end (the default) and under SMOLVISION_DEVICE_MEL=0: the rows'
    agreement (a row may part from the host-mel row only at a near tie of
    the single-clip path: its top-2 gap under phase 7's bf16 bound) and
    each run's mel ms."""
    from smolvision_tpu_torch.runtime import batch_segments as bs

    if DEV == "cuda" and not bs._use_device_mel(eng.cfg, len(segs), eng.param_dtype, eng.device):
        fail(f"phase 14: -S {SEGMENT_SEC}'s {len(segs)} bf16 segments on the card do not take "
             f"the device front end")
    out, rows = {}, {}
    for way, env in (("device", None), ("host", "0")):
        if env is not None:
            os.environ["SMOLVISION_DEVICE_MEL"] = env
        try:
            eng.perf.reset()
            rows[way] = bs.decode_segments_batched(eng, segs)
        finally:
            os.environ.pop("SMOLVISION_DEVICE_MEL", None)
        out[f"{way}_mel_ms"] = eng.perf.mel_ms
        out[f"{way}_encode_ms"] = eng.perf.encode_ms
    partings = {}
    for b, (got, want) in enumerate(zip(rows["device"], rows["host"])):
        n = min(len(got), len(want))
        part = next((i for i in range(n) if got[i] != want[i]),
                    None if len(got) == len(want) else n)
        if part is None:
            continue
        _, logits0, _, gaps = path_trace(eng, segs[b], part + 1, forced=want + [0])
        tol = PATH_RTOL["bfloat16"] * float(logits0.abs().max())
        partings[b] = {"token": part, "gap": gaps[part], "bound": tol}
        log(f"  -S {SEGMENT_SEC} row {b}: the device-mel row parts from the host-mel row at "
            f"token {part}: single-clip top-2 gap there {gaps[part]:.4g} (bound {tol:.4g})")
        if not gaps[part] < tol:
            fail(f"phase 14: -S {SEGMENT_SEC} row {b} parts from the host-mel row at token "
                 f"{part}, where the top-2 gap {gaps[part]:.4g} >= {tol:.4g}")
    out.update(rows=len(rows["host"]), tokens=sum(len(r) for r in rows["host"]),
               rows_equal=[b for b in range(len(segs)) if b not in partings],
               partings=partings)
    return out


def cref_both_ways(eng, samples) -> dict:
    """--sampler cref on the clip for THINKER_CREF_TOKENS tokens with libm's
    expf per element through the host runtime library (the default) and
    through one ctypes call per element: ms per token each; the tokens must
    be equal."""
    from smolvision_tpu_torch.runtime import sampling

    mode = eng.sampler_mode
    eng.sampler_mode = "cref"
    eng.thinker_max_tokens = THINKER_CREF_TOKENS
    out, ids = {}, {}
    real = eng.tokenizer.decode_piece
    for way in ("native", "ctypes", "native again"):
        seen = ids[way] = []
        eng.tokenizer.decode_piece = lambda t: seen.append(int(t)) or real(t)
        expf = sampling._libc_expf_ctypes if way == "ctypes" else sampling._libc_expf
        try:
            with mock.patch.object(sampling, "_libc_expf", expf):
                eng.thinker_generate(samples, None)
        finally:
            del eng.tokenizer.decode_piece
        ms = cli_ms(eng)
        out[way] = {"ms_per_token": ms["decode_ms"] / max(eng.perf.decode_steps, 1),
                    "tokens": len(seen), "decode_steps": eng.perf.decode_steps}
    eng.sampler_mode = mode
    if not (ids["native"] == ids["ctypes"] == ids["native again"]) or not ids["native"]:
        fail(f"phase 14: --sampler cref tokens differ between the expf routes: native "
             f"{ids['native']}, ctypes {ids['ctypes']}, native again {ids['native again']}")
    return out


def phase_frontend(model_dir: str, long_clip, wide_clips, clip, mstream_rounds) -> dict:
    """Phase 14: the host runtime library's build (phase 2's); TF32 off; the
    device log-mel against the host mel at -S 20's segments and a --serve 64
    encode group; -S 20 bf16 on both front ends (rows and mel ms); mel ms
    both ways at a --serve 64 group and over phase 10's multistream rounds;
    --sampler cref on both expf routes."""
    import torch

    from smolvision_tpu_torch.runtime.engine import Engine
    from smolvision_tpu_torch.runtime.serving import ENCODE_GROUP

    t0 = time.monotonic()
    out = {"native_build": NATIVE_BUILD}
    eng = Engine(model_dir, device=DEV)
    eng.set_force_language("English")
    eng.max_tokens = MAX_TOKENS
    tf32 = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if tf32["matmul.allow_tf32"] or tf32["cudnn.allow_tf32"] or \
            tf32["float32_matmul_precision"] != "highest":
        fail(f"phase 14: TF32 is on after resolve_device: {tf32}")
    segs = mesh_segments(long_clip)
    group = sorted(wide_clips, key=len, reverse=True)[:ENCODE_GROUP]
    for name, clips in ((f"-S {SEGMENT_SEC}", segs), ("--serve 64 group", group)):
        err = out[f"mel error {name}"] = frontend_mel_error(eng, clips)
        if not err["max_abs_err"] <= FRONTEND_MEL_ATOL:
            fail(f"phase 14: device log-mel at {name} differs from the host mel of the same "
                 f"f16 audio by {err['max_abs_err']:.4g} (tolerance {FRONTEND_MEL_ATOL:g})")
    out[f"-S {SEGMENT_SEC}"] = segments_both_ways(eng, segs)
    out["--serve 64 group"] = frontend_ms(eng, [group])
    out["multistream rounds"] = frontend_ms(eng, mstream_rounds)
    out["--sampler cref"] = cref_both_ways(eng, clip)
    del eng
    out["seconds"] = time.monotonic() - t0
    log(f"phase 14 (front end) [{CARD_LINE}]: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 11: the thinker and Qwen2.5-Omni-7B
# ---------------------------------------------------------------------------

class CheckpointBuild:
    """A seeded checkpoint written by a child process (one thread; a
    `torch_draw` preset drawn on `device`) while other work runs; `wait`
    joins it and gives its build seconds.  The child is killed if the
    script ends first."""

    def __init__(self, preset: str, path: str, seed: int, device: str = "cpu",
                 timeout_s: float = None, dec_layers: int = None):
        import atexit

        self.preset, self.path = preset, path
        self.timeout_s = timeout_s or Q25_BUILD_TIMEOUT_S
        code = ("import sys, time\n"
                f"sys.path.insert(0, {ROOT!r})\n"
                "import torch\n"
                "torch.set_num_threads(1)\n"
                "from smolvision_tpu_torch.models.synthetic import build\n"
                "t0 = time.monotonic()\n"
                f"build({preset!r}, {path!r}, seed={seed}, dtype='bf16', full_vocab=True, "
                f"device={device!r}, dec_layers={dec_layers!r})\n"
                "print(time.monotonic() - t0)\n")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        atexit.register(self.stop)

    def wait(self) -> dict:
        try:
            out, err = self.proc.communicate(timeout=self.timeout_s)
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"{self.preset}: the checkpoint was not written in {self.timeout_s} s")
        if self.proc.returncode != 0:
            fail(f"{self.preset}: the checkpoint build failed: {err.strip()[-2000:]}")
        size = sum(os.path.getsize(os.path.join(self.path, f)) for f in os.listdir(self.path))
        return {"build_s": float(out.strip().splitlines()[-1]), "bytes": size,
                "waited_s": time.monotonic() - self.t0}

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def q25_path_shapes(model_dir: str, samples) -> dict:
    """The attention shapes the Qwen2.5-Omni ASR route runs on this clip
    (the thinker's audio prompt with the default system prompt; the 0.6B
    checkpoint's synthetic vocab is the q25 one's): the tower's windows,
    the prefill block and its cache."""
    from smolvision_tpu_torch.config import QWEN25_OMNI_7B
    from smolvision_tpu_torch.models.q25_encoder import q25_conv_out_len
    from smolvision_tpu_torch.ops.mel import num_frames
    from smolvision_tpu_torch.runtime.buckets import bucket, window_bucket
    from smolvision_tpu_torch.runtime.engine import KV_HEADROOM
    from smolvision_tpu_torch.runtime.prompt import build_thinker_audio_prompt
    from smolvision_tpu_torch.text.tokenizer import load_tokenizer

    cfg = QWEN25_OMNI_7B
    n_tok = q25_conv_out_len(num_frames(len(samples)))
    S = cfg.q25_token_window
    W = window_bucket(n_tok, S) // S
    system = load_tokenizer(model_dir).encode("You are a helpful assistant.")
    ids, _ = build_thinker_audio_prompt(cfg, n_tok + 2, system)
    T = bucket(len(ids), 64)
    return {"q25_window_lens": [min(max(n_tok - w * S, 0), S) for w in range(W)],
            "q25_prompt_len": len(ids), "q25_prefill_T": T,
            "q25_kv_cap": bucket(T + KV_HEADROOM, 256)}


def phase_q25_kernels(shapes) -> dict:
    """Phase 3 at the shapes of phase 11's Qwen2.5-Omni-7B runs, against the
    plain versions (KERNEL_ATOL): B3 at G 7 (H 28, KH 4, D 128; the kernel
    rounds G up to 8, a dead eighth head per KV head) on a bf16 cache at
    the ASR route's decode start, at starts on and one past the cluster's
    8-block plan, and long, the position a host int and a device tensor,
    then one graph replayed at four starts; B1 at the tower's 100-token
    windows (H 20, D 64) of the 20 s clip and at a T2 of 101 (a one-row
    last window) and an all-pad window; B2 at the q25 prefill block (G 7)
    on a bf16 cache, start and kv_valid host ints and device tensors; K6 at
    the untied [152064, 3584] bf16 head, both routes, a planted winner and
    random rows.  Returns the largest error per kernel."""
    import torch

    from smolvision_tpu_torch.config import QWEN25_OMNI_7B
    from smolvision_tpu_torch.kernels import argmax_matvec as am
    from smolvision_tpu_torch.kernels import flash_attention as fa

    H, KH, D = Q25_HEADS
    errs = {"decode_attention": 0.0, "window_attention": 0.0, "causal_cache_attention": 0.0,
            "argmax_matvec": 0.0}

    def at(x):
        return torch.tensor([x], dtype=torch.int32, device=DEV)

    start0 = shapes["q25_prompt_len"]
    for K, start, kv_min in ((2048, 0, 0), (2048, 1, 0), (2048, 7, 0), (2048, 64, 0),
                             (2048, 65, 0), (2048, start0, 0), (2048, start0 + 1, 13),
                             (4096, 2330, 0), (4096, 4095, 0)):
        q, kn, vn, k, v = decode_case(K, start, H, KH, D)
        want = fa.decode_attention_plain(q, kn, vn, k, v, start, kv_min)
        for pos, lo in ((start, kv_min), (at(start), at(kv_min))):
            errs["decode_attention"] = max(errs["decode_attention"], check_close(
                f"B3 G 7 K={K} start={start} kv_min={kv_min} {type(pos).__name__} position",
                fa.decode_flash_attention(q, kn, vn, k, v, pos, lo), want))
    if DEV == "cuda":
        q, kn, vn, k, v = decode_case(2048, 2047, H, KH, D)
        pos = at(start0)
        fa.decode_flash_attention(q, kn, vn, k, v, pos)   # warm-up outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fa.decode_flash_attention(q, kn, vn, k, v, pos)
        for start in (0, start0, 2047, 65):
            pos.fill_(start)
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            errs["decode_attention"] = max(errs["decode_attention"], check_close(
                f"B3 G 7 graph replayed at start {start}", out,
                fa.decode_attention_plain(q, kn, vn, k, v, start, 0)))
        del graph

    S = QWEN25_OMNI_7B.q25_token_window
    WH, WD = Q25_WINDOW_HEADS
    for lens in (shapes["q25_window_lens"], [100, 1], [100, 37, 0, 0]):
        q, k, v, lens_t = window_case(len(lens), lens, S=S, H=WH, D=WD, garbage=True)
        want = fa.window_attention_plain(q, k, v, lens_t)
        for split in window_splits(S):
            with window_split(split):
                got = fa.window_flash_attention(q, k, v, lens_t)
            errs["window_attention"] = max(errs["window_attention"], check_close(
                f"B1 q25 S={S} H={WH} lens={lens[:8]} split={split}", got, want))
            for w in (w for w, n in enumerate(lens) if n == 0):
                if float(got[w].abs().max()) != 0.0:
                    fail(f"B1 q25 lens={lens}: all-pad window {w} is not exactly 0")

    T, valid, K = shapes["q25_prefill_T"], shapes["q25_prompt_len"], shapes["q25_kv_cap"]
    for start, kv_valid in ((0, valid), (300, 300 + 117)):
        q, k, v = cache_case(T, K + 512, start, kv_valid, H, KH, D)
        want = fa.causal_cache_attention_plain(q, k, v, start, kv_valid)
        dev_start = torch.tensor([start], dtype=torch.int64, device=DEV)
        for form, s0, n in (("host", start, kv_valid),
                            ("device", dev_start, dev_start + (kv_valid - start))):
            errs["causal_cache_attention"] = max(errs["causal_cache_attention"], check_close(
                f"B2 q25 T={T} start={start} valid={kv_valid} {form} start",
                fa.causal_cache_flash_attention(q, k, v, s0, n), want))

    V, Hd = QWEN25_OMNI_7B.vocab_size, QWEN25_OMNI_7B.dec_hidden
    for i, (planted, route) in enumerate(((True, "cuda_core"), (False, "cuda_core"),
                                          (True, "tensor_core"), (False, "tensor_core"))):
        h, w, scale, winners = head_case(V, Hd, 1, "bfloat16", 600 + i, planted)
        errs["argmax_matvec"] = max(errs["argmax_matvec"], check_head(
            f"K6 q25 [{V}, {Hd}] planted={planted} {route}", h, w, scale, winners, route))
        del h, w
    log(f"Qwen2.5-Omni shapes vs plain: max_abs_err {json.dumps(errs)} (tolerance "
        f"{KERNEL_ATOL:g}; K6: shortfall, tolerance {HEAD_RTOL:g} of max |logit|)")
    return errs


def cli_ms(eng) -> dict:
    """A thinker run's phase times (engine.perf) and decode ms per step."""
    perf = eng.perf
    loop_ms = perf.decode_ms - perf.prefill_ms
    return {"encode_ms": perf.encode_ms, "prefill_ms": perf.prefill_ms,
            "decode_ms": loop_ms, "decode_steps": perf.decode_steps,
            "decode_ms_per_step": loop_ms / max(perf.decode_steps, 1),
            "text_tokens": perf.text_tokens, "wasted_steps": perf.wasted_steps,
            "realtime_factor": perf.audio_ms / max(perf.total_ms, 1e-9)}


def thinker_summary(name: str, eng) -> None:
    """THINKER_RUNS[name]: the graph turn's phase times (`cli_ms`), and per
    turn of the run_path summary of `name` its captures against caches,
    host reads against chunks, peak memory, realtime factor, decode ms per
    step and deepest cache row."""
    run = DECODE_RUNS[name]
    out = dict(cli_ms(eng))
    for key in ("captures", "caches", "host_reads", "chunks", "max_memory_allocated_gib",
                "realtime_factor", "decode_ms_per_step", "last_row"):
        out[f"{key}_turns"] = run[key]
    THINKER_RUNS[name] = out
    log(f"  {name}: {json.dumps(out)}")


@contextlib.contextmanager
def load_timer():
    """Records the seconds of every Engine construction in the block (the
    checkpoint's load onto the card)."""
    from smolvision_tpu_torch.runtime.engine import Engine

    times = []
    init = Engine.__init__

    def timed(self, *args, **kwargs):
        if DEV == "cuda":
            import torch

            torch.cuda.synchronize()
        t0 = time.monotonic()
        init(self, *args, **kwargs)
        if DEV == "cuda":
            import torch

            torch.cuda.synchronize()
        times.append(time.monotonic() - t0)

    with mock.patch.object(Engine, "__init__", timed):
        yield times


def phase_thinker(model_dir: str, wav: str, cfg) -> dict:
    """The thinker through the CLI on the 0.6B checkpoint: greedy on text
    (K6, B3 in the decode loop's graph) and sampled on the 20 s clip at the
    defaults (temperature 0.7, top-k 40, penalty 1.1, seed 0: SampleLoop,
    one graph of a sampled step per cache, B3 per layer), each eager then
    as CUDA graphs with equal tokens; sampled again at --max-tokens 2048
    (graph only: B3 to about 2330 rows); `--top-k 1 --repeat-penalty 1.0`
    sampled against greedy on --f32 (equal stdout); `--sampler cref` on 16
    tokens (ms per token).  Returns the launches and shapes the kernels line
    takes from it."""
    import gc

    base = ["-d", model_dir, "--silent"]
    eng = run_path(base + ["--thinker", "--text", THINKER_TEXT, "--temperature", "0",
                           "--max-tokens", str(THINKER_MAX_TOKENS)],
                   "thinker greedy --text", cfg)[0]
    thinker_summary("thinker greedy --text", eng)
    del eng
    gc.collect()
    eng = run_path(base + ["--thinker", "-i", wav, "--max-tokens", str(THINKER_MAX_TOKENS)],
                   "thinker sampled -i", cfg, loop_kind="sample")[0]
    thinker_summary("thinker sampled -i", eng)
    del eng
    gc.collect()
    eng, launches, _, _ = run_path(
        base + ["--thinker", "-i", wav, "--max-tokens", str(THINKER_LONG_TOKENS)],
        "thinker sampled 2048", cfg, loop_kind="sample", turns=("graph",))
    thinker_summary("thinker sampled 2048", eng)
    long = {"K": eng._kv_cap, "start": DECODE_RUNS["thinker sampled 2048"]["last_row"]["graph"],
            "launches": launches["decode_attention"]}
    del eng
    gc.collect()

    lines = {}
    for name, extra in (("top-k 1", ["--top-k", "1", "--repeat-penalty", "1.0"]),
                        ("greedy", ["--temperature", "0"])):
        eng, launches, lines[name], _ = run_cli(
            base + ["--thinker", "-i", wav, "--f32", "--max-tokens", str(THINKER_MAX_TOKENS)]
            + extra, f"thinker {name} --f32")
        check_launches(f"thinker {name} --f32", launches, eng, cfg)
        del eng
        gc.collect()
    if lines["top-k 1"] != lines["greedy"] or not "".join(lines["greedy"]).strip():
        fail(f"thinker --f32: --top-k 1 --repeat-penalty 1.0 sampled {lines['top-k 1']} != "
             f"greedy {lines['greedy']}")
    log(f"  thinker --f32: --top-k 1 --repeat-penalty 1.0 sampled equals greedy "
        f"({len(''.join(lines['greedy']))} characters)")

    eng, launches, _, wall_s = run_cli(
        base + ["--thinker", "-i", wav, "--sampler", "cref", "--max-tokens",
                str(THINKER_CREF_TOKENS)], "thinker --sampler cref")
    check_launches("thinker --sampler cref", launches, eng, cfg)
    ms = cli_ms(eng)
    ms["ms_per_token"] = ms["decode_ms"] / max(eng.perf.decode_steps, 1)
    THINKER_RUNS["thinker --sampler cref"] = ms
    log(f"  thinker --sampler cref ({THINKER_CREF_TOKENS} tokens, libm expf per element "
        f"in the host runtime library): {json.dumps(ms)}")
    del eng
    gc.collect()
    return long


def phase_q25(q25_dir: str, wav: str, build: dict) -> dict:
    """Qwen2.5-Omni-7B (seeded bf16, full geometry) through the CLI: the 20 s
    clip with no --thinker (the ASR route: the thinker with the default
    system prompt at temperature 0.7, SampleLoop) at --max-tokens 512,
    `--thinker --temperature 0 --max-tokens 64` on the clip (the greedy loop,
    K6 at [152064, 3584]), each eager then as CUDA graphs with equal
    tokens, and `--thinker --text` (sampled, graph).  Every Engine
    construction (the checkpoint's load onto the card) is timed."""
    import gc

    from smolvision_tpu_torch.config import detect_config
    from smolvision_tpu_torch.models.synthetic import PRESETS

    qcfg = detect_config(q25_dir)
    p = PRESETS[Q25_PRESET]
    if ((qcfg.family, qcfg.dec_layers, qcfg.dec_hidden, qcfg.enc_layers, qcfg.vocab_size)
            != ("q25", p["dec_L"], p["dec_h"], p["enc_L"], p["vocab"])):
        fail(f"{Q25_PRESET}: detected {qcfg}")
    base = ["-d", q25_dir, "--silent"]
    out = {"build": build}
    with load_timer() as loads:
        eng, launches, lines, _ = run_path(
            base + ["-i", wav, "--max-tokens", str(Q25_ASR_MAX_TOKENS)], "q25 ASR route", qcfg,
            loop_kind="sample")
        if eng.prompt_text != "You are a helpful assistant." or eng.temperature != 0.7:
            fail(f"q25 ASR route: prompt {eng.prompt_text!r}, temperature {eng.temperature}")
        thinker_summary("q25 ASR route", eng)
        out["asr"] = {"launches": launches, "K": eng._kv_cap,
                      "start": DECODE_RUNS["q25 ASR route"]["last_row"]["graph"]}
        del eng
        gc.collect()
        eng, launches, _, _ = run_path(
            base + ["--thinker", "-i", wav, "--temperature", "0", "--max-tokens",
                    str(Q25_GREEDY_MAX_TOKENS)], "q25 thinker greedy", qcfg)
        thinker_summary("q25 thinker greedy", eng)
        out["greedy"] = {"launches": launches}
        del eng
        gc.collect()
        eng, launches, _, _ = run_path(
            base + ["--thinker", "--text", THINKER_TEXT, "--max-tokens",
                    str(Q25_TEXT_MAX_TOKENS)], "q25 thinker --text", qcfg, loop_kind="sample",
            turns=("graph",))
        thinker_summary("q25 thinker --text", eng)
        del eng
        gc.collect()
    out["load_s"] = loads
    log(f"  {Q25_PRESET}: built in {build['build_s']:.1f} s ({build['bytes'] / 1e9:.2f} GB; "
        f"waited for {build['waited_s']:.1f} s since its start), loaded in "
        f"{', '.join(f'{t:.1f}' for t in loads)} s")
    return out


def q25_kernel_table(shapes, q25_run: dict, long: dict, errs: dict) -> list:
    """The kernels line's rows at phase 11's shapes, each checked again on
    its timing inputs and timed (turns plain, kernel, kernel, plain) beside
    its library call and its bound, its launches those of the run that
    carries it: B1 at the q25 tower's windows of the 20 s clip (H 20, D 64;
    the ASR route's graph turn), B2 at the q25 prefill (G 7; the same run),
    B3 at G 7 at that run's deepest decode row and cache, B3 at the 0.6B
    sampled 2048-token run's deepest row and cache (0.6B heads), and K6 at
    the q25 head [152064, 3584] bf16, R 1 (the greedy q25 run's graph
    turn)."""
    import torch

    from smolvision_tpu_torch.config import QWEN25_OMNI_7B
    from smolvision_tpu_torch.kernels import argmax_matvec as am

    asr = q25_run["asr"]["launches"]
    H, KH, D = Q25_HEADS
    WH, WD = Q25_WINDOW_HEADS
    S = QWEN25_OMNI_7B.q25_token_window
    B1_SRC = "smolvision_tpu_torch/kernels/csrc/window_attention.cu"
    rows = [("window_attention_q25", B1_SRC, "smolvision_tpu/kernels/flash_attention.py:60",
             *window_row(shapes["q25_window_lens"], S=S, H=WH, D=WD)[:4]),
            ("causal_cache_attention_q25",
             "smolvision_tpu_torch/kernels/csrc/causal_cache_attention.cu",
             "smolvision_tpu/kernels/flash_attention.py:491",
             *cache_row(shapes["q25_prefill_T"], shapes["q25_kv_cap"], 0,
                        shapes["q25_prompt_len"], heads=Q25_HEADS)),
            ("decode_attention_q25", "smolvision_tpu_torch/kernels/csrc/decode_attention.cu",
             "smolvision_tpu/kernels/flash_attention.py:184",
             *decode_row(q25_run["asr"]["K"], q25_run["asr"]["start"], heads=Q25_HEADS)),
            ("decode_attention_thinker_long",
             "smolvision_tpu_torch/kernels/csrc/decode_attention.cu",
             "smolvision_tpu/kernels/flash_attention.py:184",
             *decode_row(long["K"], long["start"]))]
    row_errs = dict(errs)
    for name, _, _, kern, plain, _, _ in rows:
        row_errs[name] = max(errs[kernel_of(name)], check_close(f"{name} timing inputs",
                                                                kern(), plain()))
    table = timed_table(rows, row_errs, {})
    launches = {"window_attention_q25": asr["window_attention"],
                "causal_cache_attention_q25": asr["causal_cache_attention"],
                "decode_attention_q25": asr["decode_attention"],
                "decode_attention_thinker_long": long["launches"]}
    V, Hd = QWEN25_OMNI_7B.vocab_size, QWEN25_OMNI_7B.dec_hidden
    h, w, _, _ = head_case(V, Hd, 1, "bfloat16", 700)
    err = max(errs["argmax_matvec"], check_head("argmax_matvec_q25 timing inputs", h, w))
    hb = h.to(torch.bfloat16)
    kern = lambda: am.argmax_matvec(h, w)   # noqa: E731
    plain = lambda: am.argmax_matvec_plain(h, w)   # noqa: E731
    p1, k1, k2, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
    lib_ms = time_ms(lambda: torch.argmax(torch.mm(hb, w.t(), out_dtype=torch.float32), dim=-1))
    nbytes = w.numel() * w.element_size() + 4 * (Hd + 1)
    bound_ms, bound_by = bound(nbytes, 2.0 * V * Hd, "bfloat16")
    table.append({"name": "argmax_matvec_q25", "route": "cuda",
                  "source": "smolvision_tpu_torch/kernels/csrc/argmax_matvec.cu",
                  "replaces": "tools/profile_decode2.py:127", "max_abs_err": err,
                  "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "design": am.head_route(1, w.dtype).replace("_", " ") + "s"})
    log(f"  argmax_matvec_q25: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    launches["argmax_matvec_q25"] = q25_run["greedy"]["launches"]["argmax_matvec"]
    for row in table:
        row["launches"] = launches[row["name"]]
    return table

# ---------------------------------------------------------------------------
# phase 12: Qwen3-Omni-30B-A3B, resident (the MoE decoder)
# ---------------------------------------------------------------------------

def omni_step_bytes(cfg, int8: bool = False) -> dict:
    """Bytes one 30B decode step must read (bf16 weights, or int8 with one
    f32 scale per output row under --q8; the f32 router): attention,
    router and the K chosen experts of every layer, then the head (the
    tied embedding); and what the gather copies per step (K expert blocks
    of each of the three matrices per layer, read and written once
    each)."""
    H, D, KH, hid = cfg.dec_heads, cfg.dec_head_dim, cfg.dec_kv_heads, cfg.dec_hidden
    K, E, MI = cfg.num_experts_per_tok, cfg.num_experts, cfg.moe_intermediate
    wb, sb = (1, 4) if int8 else (2, 0)   # bytes per weight, per output row's scale
    attn = wb * ((H * D + 2 * KH * D) * hid + hid * H * D) + sb * (H * D + 2 * KH * D + hid)
    router = 4 * E * hid
    expert = wb * 3 * MI * hid + sb * (2 * MI + hid)   # one expert's three matrices
    experts = K * expert
    layers = cfg.dec_layers * (attn + router + experts)
    head = wb * cfg.vocab_size * hid + sb * cfg.vocab_size
    return {"weights_gb": (layers + head) / 1e9, "attention_gb": cfg.dec_layers * attn / 1e9,
            "attention_router_gb": cfg.dec_layers * (attn + router) / 1e9,
            "experts_gb": cfg.dec_layers * experts / 1e9,
            "head_gb": head / 1e9, "bound_ms": (layers + head) / HBM_BYTES_PER_S * 1e3,
            "gather_copy_gb": cfg.dec_layers * experts / 1e9,
            "all_experts_gb": cfg.dec_layers * E * expert / 1e9}


def phase_omni_kernels(shapes) -> dict:
    """Phase 3 at the 30B's shapes against the plain versions
    (KERNEL_ATOL): B1 at its encoder's 104-token windows (H 20, D 64) of
    the 20 s clip, under each split, and an all-pad window; B2 at the
    offline prefill block (H 32 over 4 KV heads: G 8) on a bf16 cache,
    start and kv_valid host ints and device tensors; B3 at G 8 at starts on
    and off the cluster plan, the position a host int and a device tensor,
    and one graph replayed at four starts; B4 at the -S run's batch (B 6)
    and an all-pad row at G 8; K6 over the [151936, 2048] head at R 1 and
    the -S batch, both routes, planted winners and random rows.  Returns
    the largest error per kernel."""
    import torch

    from smolvision_tpu_torch.config import QWEN3_OMNI_30B
    from smolvision_tpu_torch.kernels import flash_attention as fa

    H, KH, D = OMNI_HEADS
    WH, WD = OMNI_WINDOW_HEADS
    errs = {k: 0.0 for k in ("window_attention", "causal_cache_attention", "decode_attention",
                             "batched_causal_attention", "argmax_matvec")}

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=DEV)

    for lens in (shapes["window_lens"], [104, 104, 3, 0]):
        q, k, v, lens_t = window_case(len(lens), lens, S=104, H=WH, D=WD, garbage=True)
        want = fa.window_attention_plain(q, k, v, lens_t)
        for split in window_splits(104):
            with window_split(split):
                got = fa.window_flash_attention(q, k, v, lens_t)
            errs["window_attention"] = max(errs["window_attention"], check_close(
                f"B1 omni H={WH} lens={lens} split={split}", got, want))

    T, valid, K = shapes["prefill_T"], shapes["prompt_len"], shapes["kv_cap"]
    for start, kv_valid in ((0, valid), (300, 300 + 117)):
        q, k, v = cache_case(T, K + 512, start, kv_valid, H, KH, D)
        want = fa.causal_cache_attention_plain(q, k, v, start, kv_valid)
        dev_start = torch.tensor([start], dtype=torch.int64, device=DEV)
        for form, s0, n in (("host", start, kv_valid),
                            ("device", dev_start, dev_start + (kv_valid - start))):
            errs["causal_cache_attention"] = max(errs["causal_cache_attention"], check_close(
                f"B2 omni T={T} start={start} valid={kv_valid} {form} start",
                fa.causal_cache_flash_attention(q, k, v, s0, n), want))

    pos0 = shapes["decode_pos"]
    for K3, start, kv_min in ((1024, 0, 0), (1024, 7, 0), (1024, 65, 0), (1024, pos0, 0),
                              (1024, pos0 + 1, 13), (4096, 4095, 0)):
        q, kn, vn, k, v = decode_case(K3, start, H, KH, D)
        want = fa.decode_attention_plain(q, kn, vn, k, v, start, kv_min)
        for p0, lo in ((start, kv_min), (ints([start]), ints([kv_min]))):
            errs["decode_attention"] = max(errs["decode_attention"], check_close(
                f"B3 omni K={K3} start={start} kv_min={kv_min} {type(p0).__name__} position",
                fa.decode_flash_attention(q, kn, vn, k, v, p0, lo), want))
    if DEV == "cuda":
        q, kn, vn, k, v = decode_case(1024, 1023, H, KH, D)
        at = ints([pos0])
        fa.decode_flash_attention(q, kn, vn, k, v, at)   # warm-up outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fa.decode_flash_attention(q, kn, vn, k, v, at)
        for start in (0, pos0, 1023, 65):
            at.fill_(start)
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            errs["decode_attention"] = max(errs["decode_attention"], check_close(
                f"B3 omni graph replayed at start {start}", out,
                fa.decode_attention_plain(q, kn, vn, k, v, start, 0)))
        del graph

    B4, T4 = shapes["seg_B"], shapes["seg_T"]
    for B, kv_min in ((B4, shapes["seg_pads"]), (3, [T4, 1, 200])):
        q, k, v = batched_case(B, T4, H, KH, D)
        got = fa.batched_causal_flash_attention(q, k, v, ints(kv_min))
        errs["batched_causal_attention"] = max(errs["batched_causal_attention"], check_close(
            f"B4 omni B={B} T={T4} kv_min={kv_min}", got,
            fa.batched_causal_attention_plain(q, k, v, ints(kv_min))))

    V, Hd = QWEN3_OMNI_30B.vocab_size, QWEN3_OMNI_30B.dec_hidden
    for i, (R, planted, route) in enumerate((r, p, route) for r in (1, B4) for p in (True, False)
                                            for route in ("cuda_core", "tensor_core")):
        h, w, scale, winners = head_case(V, Hd, R, "bfloat16", 800 + i, planted)
        errs["argmax_matvec"] = max(errs["argmax_matvec"], check_head(
            f"K6 omni [{V}, {Hd}] R={R} planted={planted} {route}", h, w, scale, winners, route))
        del h, w
    log(f"Qwen3-Omni-30B shapes vs plain: max_abs_err {json.dumps(errs)} (tolerance "
        f"{KERNEL_ATOL:g}; K6: shortfall, tolerance {HEAD_RTOL:g} of max |logit|)")
    return errs


@contextlib.contextmanager
def resident_weights():
    """Every Engine built in the block shares the first one's weights on
    the card: the port's loaders are called once per (loader, parameter
    dtype) and their tensors kept, so the 30B (62 GB) is read from disk
    once, not once per CLI run.  Yields the kept tensors."""
    from smolvision_tpu_torch.models import params as params_mod

    kept = {}

    def keep(name):
        real = getattr(params_mod, name)

        def load(reader, cfg, param_dtype, device=None, **kw):
            key = (name, param_dtype, *sorted(kw.items()))
            if key not in kept:
                kept[key] = real(reader, cfg, param_dtype, device, **kw)
            return kept[key]
        return load

    with mock.patch.object(params_mod, "load_qwen3_encoder", keep("load_qwen3_encoder")), \
            mock.patch.object(params_mod, "load_decoder", keep("load_decoder")):
        yield kept


def omni_summary(name: str, eng, step: dict, dense: bool = False) -> None:
    """OMNI_RUNS[name]: the graph turn's phase times (`cli_ms`), per turn
    its decode ms per step, captures against caches, peak memory and
    realtime factor (run_path's summary of `name`), and the step's bytes:
    its weight-read bound and what the gather copies, or, for a `dense`
    step (above moe.GATHER_MAX_T rows), every expert's bytes."""
    run = DECODE_RUNS[name]
    out = dict(cli_ms(eng))
    if eng.perf.batch_decode_steps:
        out["decode_ms_per_step"] = eng.perf.batch_decode_ms / eng.perf.batch_decode_steps
    for key in ("decode_ms_per_step", "captures", "caches", "prefill_captures", "prefill_keys",
                "host_reads", "chunks", "max_memory_allocated_gib", "realtime_factor",
                "last_row"):
        if key in run:
            out[f"{key}_turns"] = run[key]
    out["step_weight_read_bound_ms"] = step["bound_ms"]
    if dense:
        out["all_experts_gb_per_step"] = step["all_experts_gb"]
    else:
        out["gather_copy_gb_per_step"] = step["gather_copy_gb"]
    OMNI_RUNS[name] = out
    log(f"  {name}: {json.dumps(out)}")


def omni_overflow_forward(eng) -> dict:
    """One MoE layer of the 30B (layer 0's router and experts, bf16) at T 64
    with its router forced to overflow: rows 0-7 of a copy of the router
    raised by 1.0, and positive activations, so every token picks experts
    0-7 (queues of C = ceil(64 * 8 / 128 * 2) = 8 rows: 448 of the 512
    (token, expert) pairs past capacity).  The eager forward dispatches,
    reads the drop count on the host and falls back to dense; the same
    forward as a graph step's (graph_safe), captured as a CUDA graph, runs
    dense with no host read.  Their outputs must be equal."""
    import torch

    from smolvision_tpu_torch.models import moe
    from smolvision_tpu_torch.models.qwen3_decoder import MOE_KEYS, layer_params

    cfg = eng.cfg
    lp = {k: v for k, v in layer_params(eng.dec_params)[0].items() if k in MOE_KEYS}
    lp["router"] = lp["router"].clone()
    lp["router"][:8] += 1.0
    T = OMNI_OVERFLOW_T
    g = torch.Generator(device=DEV).manual_seed(900)
    x = torch.randn(T, cfg.dec_hidden, device=DEV, generator=g).abs() + 0.1
    top_idx, top_w = moe.route(x, lp["router"], cfg)
    _, n_dropped = moe.capacity_dispatch(x.to(lp["e_gate"].dtype), lp, top_idx, top_w,
                                         torch.ones(T, dtype=torch.bool, device=DEV))
    if int(n_dropped) == 0:
        fail("omni overflow forward: the forced routing did not overflow")
    eager = moe.moe_ffn(x, lp, cfg)
    if DEV == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe.moe_ffn(x, lp, cfg, graph_safe=True)   # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe.moe_ffn(x, lp, cfg, graph_safe=True)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        del graph
    else:   # a CPU rehearsal: the graph-safe forward run eagerly
        out = moe.moe_ffn(x, lp, cfg, graph_safe=True)
    err = check_close("omni overflow forward: captured vs eager", out, eager)
    result = {"T": T, "n_dropped": int(n_dropped), "pairs": T * cfg.num_experts_per_tok,
              "capacity": moe.capacity(T, cfg.num_experts_per_tok, cfg.num_experts),
              "max_abs_err": err, "max_abs_out": float(eager.abs().max()),
              "eager_ms": eager_ms(lambda: moe.moe_ffn(x, lp, cfg), iters=5, warmup=1),
              "graph_ms": time_ms(lambda: moe.moe_ffn(x, lp, cfg, graph_safe=True), iters=5)}
    log(f"  omni overflow forward (T {T}, forced routing), captured vs eager: "
        f"{json.dumps(result)}")
    return result


def phase_omni_int8(omni_dir: str, wav: str, long_wav: str, shapes, ocfg) -> dict:
    """--q8 (int8 experts) and --spec (their int8 draft) offline on the 20 s
    clip, and `-S 20 --q8` on the 120 s clip (the batched step dense over
    the int8 stacks at B 6), each eager then as graphs with equal tokens
    (`run_path`), beside the int8 step's weight-read bound; --spec's tokens
    against plain greedy on the same engine (bf16: equal up to the first
    near tie).  Returns each run's launches, the verify's B2 launches and
    its cache shape."""
    import gc

    from smolvision_tpu_torch.io.wav import load_wav
    from smolvision_tpu_torch.ops.quant import QuantW
    from smolvision_tpu_torch.runtime import engine as eng_mod

    clip = load_wav(wav)
    step8 = omni_step_bytes(ocfg, int8=True)
    log(f"  {OMNI_PRESET} int8 decode step bytes: {json.dumps(step8)}")
    base = ["-d", omni_dir, "--silent", "--language", "English", "--max-tokens", str(MAX_TOKENS)]
    runs = {}
    eng, runs["--q8"], _, _ = run_path(base + ["-i", wav, "--q8"], "omni --q8", ocfg)
    if not (eng.q8 and all(isinstance(eng.dec_params["layers"][k], QuantW)
                           for k in ("e_gate", "e_up", "e_down"))):
        fail("omni --q8: the expert stacks are not int8")
    omni_summary("omni --q8", eng, step8)
    del eng
    gc.collect()
    eng, runs["--spec"], _, _ = run_path(base + ["-i", wav, "--spec"], "omni --spec", ocfg)
    perf = eng.perf
    if not (eng.spec and isinstance(eng.dec_params_draft["layers"]["e_gate"], QuantW)
            and perf.spec_iters and perf.decode_steps == eng_mod.SPEC_DRAFT * perf.spec_iters):
        fail(f"omni --spec: {perf.spec_iters} verifies, {perf.decode_steps} draft steps")
    run = DECODE_RUNS["omni --spec"]
    runs["--spec verify"] = ocfg.dec_layers * (perf.spec_iters + perf.wasted_steps)
    runs["verify_at"] = (eng._kv_cap, run["last_row"]["graph"] - eng_mod.SPEC_DRAFT)
    plain_ms = OMNI_RUNS["omni offline"]["decode_ms_per_step_turns"]["graph"]
    summary = {"spec_iters": perf.spec_iters, "spec_tokens": perf.spec_tokens,
               "tokens_per_verify": perf.spec_tokens / perf.spec_iters,
               "decode_ms_per_token_turns": run["decode_ms_per_token"],
               "plain_offline_ms_per_step": plain_ms,
               "verify_rows_dense_gb": omni_step_bytes(ocfg)["all_experts_gb"],
               "vs_plain_greedy": spec_vs_plain(eng, clip, MAX_TOKENS, exact=False)}
    OMNI_RUNS["omni --spec"] = summary
    log(f"  omni --spec: {json.dumps(summary)}")
    del eng
    gc.collect()
    eng, runs["-S q8"], _, _ = run_path(
        base + ["-i", long_wav, "-S", str(SEGMENT_SEC), "--q8"], "omni -S 20 --q8", ocfg,
        batch=shapes["seg_B"])
    if eng.perf.batch_decode_steps == 0:
        fail("omni -S 20 --q8: no batched decode step ran")
    omni_summary("omni -S 20 --q8", eng, step8, dense=True)
    del eng
    gc.collect()
    return runs


@contextlib.contextmanager
def offload_record():
    """The host-offload engines the block builds, each with its uploads'
    CUDA events recorded (HostExpertStore.copy_events), and the tokens
    every decode_greedy call shows its caller."""
    from smolvision_tpu_torch.models import moe_offload
    from smolvision_tpu_torch.runtime.engine import Engine

    rec = {"stores": [], "tokens": [], "preloads": []}
    init = moe_offload.HostExpertStore.__init__
    preload = moe_offload.HostExpertStore.preload
    greedy = Engine.decode_greedy

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.copy_events = [] if DEV == "cuda" else None
        rec["stores"].append(self)

    def timed_preload(self):
        t0 = time.monotonic()
        n = preload(self)
        rec["preloads"].append({"bytes": n, "s": time.monotonic() - t0})
        return n

    def recording_greedy(self, first, pos, max_tokens, on_token):
        toks = []
        rec["tokens"].append(toks)
        return greedy(self, first, pos, max_tokens, lambda t: toks.append(t) or on_token(t))

    with mock.patch.object(moe_offload.HostExpertStore, "__init__", recording_init), \
            mock.patch.object(moe_offload.HostExpertStore, "preload", timed_preload), \
            mock.patch.object(Engine, "decode_greedy", recording_greedy):
        yield rec


def link_rate() -> dict:
    """One pinned LINK_COPY_BYTES host-to-device copy, timed by CUDA events
    (the best of three after a warm-up)."""
    import torch

    if DEV != "cuda":
        return {"bytes": 0, "ms": "not measured", "gb_per_s": "not measured"}
    src = torch.ones(LINK_COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(LINK_COPY_BYTES, dtype=torch.uint8, device=DEV)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = min(times)
    return {"bytes": LINK_COPY_BYTES, "ms": ms, "gb_per_s": LINK_COPY_BYTES / ms / 1e6}


def host_memory() -> dict:
    """This process's resident and peak resident host memory (GB)."""
    with open("/proc/self/status") as f:
        status = {line.split(":")[0]: line.split()[1:] for line in f}
    return {k: int(status[k][0]) * 1024 / 1e9 for k in ("VmRSS", "VmHWM") if k in status}


def offload_summary(name: str, eng, store, samples, resident_tokens, tokens,
                    step: dict) -> dict:
    """Per decoded token of an offload run: wall ms, the router reads' host
    wait (the device's work up to each read, and the read), the host
    gather, the uploads' bytes, ms (CUDA events) and GB/s; the prefill's
    whole-stack stream; peak device memory; the tokens against the
    resident run's (equal, or parting where the offload engine's top-2
    logit gap is a near tie: under PATH_RTOL of its largest prefill
    logit)."""
    import torch

    perf, st = eng.perf, store.stats
    steps = max(perf.decode_steps, 1)
    ev = {"gather": 0.0, "full": 0.0}
    for kind, a, b in store.copy_events or ():
        ev[kind] += a.elapsed_time(b)
    n_moe = sum(store.is_moe)
    if st["router_reads"] != n_moe * perf.decode_steps:
        fail(f"{name}: {st['router_reads']} router reads over {perf.decode_steps} steps of "
             f"{n_moe} MoE layers (one per layer per token expected)")
    if any(eng.dec_params["layers"].get(k) is not None for k in ("e_gate", "e_up", "e_down")):
        fail(f"{name}: an expert stack is resident")
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else 0.0
    if peak >= step["all_experts_gb"]:
        fail(f"{name}: {peak:.2f} GB allocated at the peak, as much as the expert stacks")
    out = {"tokens": len(tokens), "decode_steps": perf.decode_steps,
           "decode_ms_per_token": (perf.decode_ms - perf.prefill_ms) / steps,
           "router_reads_per_token": st["router_reads"] / steps,
           "router_read_wait_ms_per_token": st["router_read_s"] * 1e3 / steps,
           "host_gather_ms_per_token": st["gather_host_s"] * 1e3 / steps,
           "h2d_bytes_per_token": st["gather_bytes"] / steps,
           "h2d_ms_per_token": ev["gather"] / steps if DEV == "cuda" else "not measured",
           "h2d_gb_per_s": (st["gather_bytes"] / ev["gather"] / 1e6 if ev["gather"]
                            else "not measured"),
           "prefill_ms": perf.prefill_ms, "prefill_stream_gb": st["full_bytes"] / 1e9,
           "prefill_stream_host_ms": st["full_host_s"] * 1e3,
           "prefill_stream_h2d_ms": ev["full"] if DEV == "cuda" else "not measured",
           "encode_ms": perf.encode_ms, "realtime_factor": perf.audio_ms / max(perf.total_ms, 1),
           "max_memory_allocated_gb": peak, "resident_experts": 0}
    n = min(len(tokens), len(resident_tokens))
    part = next((i for i in range(n) if tokens[i] != resident_tokens[i]),
                None if len(tokens) == len(resident_tokens) else n)
    out["equal_prefix"] = n if part is None else part
    if part is not None:
        _, logits0, _, gaps = path_trace(eng, samples, part + 1, forced=resident_tokens + [0])
        tol = PATH_RTOL[str(eng.param_dtype).replace("torch.", "")] * float(logits0.abs().max())
        out.update(parting_gap=gaps[part], gap_bound=tol)
        if not gaps[part] < tol:
            fail(f"{name}: tokens part from the resident run's at {part} where the top-2 gap "
                 f"{gaps[part]:.4g} >= {tol:.4g}")
    return out


def offload_steps(eng, samples, n: int):
    """A prefill of the clip on the offload engine, then a callable that runs
    the next n greedy decode steps (for `profile_window`)."""
    import torch

    from smolvision_tpu_torch.ops.mel import log_mel
    from smolvision_tpu_torch.runtime.prompt import build_asr_prompt

    with torch.inference_mode():
        enc, n_audio = eng.encode_mel(log_mel(samples))
        ids, a0 = build_asr_prompt(eng.cfg, n_audio, eng._prompt_tokens, eng._force_tokens)
        eng.reset_kv()
        tok, pos = eng.prefill_ids(ids, enc, a0, n_audio)
    state = {"tok": int(tok), "pos": pos}

    def run() -> int:
        for _ in range(n):
            state["tok"] = int(eng.decode_step(state["tok"], state["pos"]))
            state["pos"] += 1
        return n
    return run


def phase_omni_offload(omni_dir: str, wav: str, resident_tokens, ocfg) -> dict:
    """The 30B with its experts on the host (--moe-offload), after the
    resident weights are freed: the link's rate once (a pinned 1 GB copy);
    offline on the 20 s clip to MAX_TOKENS tokens, without and with
    --moe-preload, each through the CLI with the launch counts checked,
    its tokens against the resident offline run's, per token the router
    reads, host gather, uploads and device time (torch.profiler over
    OMNI_OFFLOAD_PROFILE_STEPS steps of the first), the prefill's
    whole-stack stream and the peak device memory (no expert stack on the
    card); then `--thinker --text --moe-offload` sampled (the host Sampler
    per token, no CUDA graph) twice with the same seed: equal output.  Ends
    with the host's resident memory."""
    import gc

    import torch

    from smolvision_tpu_torch.io.wav import load_wav

    clip = load_wav(wav)
    step = omni_step_bytes(ocfg)
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    out = {"link": link_rate()}
    log(f"  host-to-device link, one pinned {LINK_COPY_BYTES} B copy: {json.dumps(out['link'])}")
    base = ["-d", omni_dir, "--silent", "--language", "English", "-i", wav, "--max-tokens",
            str(MAX_TOKENS), "--moe-offload"]
    for name, extra in (("omni --moe-offload", []),
                        ("omni --moe-offload --moe-preload", ["--moe-preload"])):
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with offload_record() as rec:
            eng, launches, _, wall_s = run_cli(base + extra, name)
        check_launches(name, launches, eng, ocfg)
        if not eng.moe_offload or len(rec["stores"]) != 1 or len(rec["tokens"]) != 1:
            fail(f"{name}: not one offload engine and one greedy decode")
        if bool(extra) != bool(rec["preloads"]):
            fail(f"{name}: preloads {rec['preloads']}")
        summary = offload_summary(name, eng, rec["stores"][0], clip, resident_tokens,
                                  rec["tokens"][0], step)
        summary.update(wall_s=wall_s, launches=launches, preload=rec["preloads"])
        if not extra and DEV == "cuda":
            window = profile_window(offload_steps(eng, clip, OMNI_OFFLOAD_PROFILE_STEPS))
            summary["profile"] = window
        OMNI_RUNS[name] = summary
        log(f"  {name}: {json.dumps(summary)}")
        out[name] = summary
        del eng
        gc.collect()
    argv = ["-d", omni_dir, "--silent", "--thinker", "--text", THINKER_TEXT, "--max-tokens",
            str(OMNI_OFFLOAD_THINKER_TOKENS), "--moe-offload"]
    texts = []
    for turn in range(2):
        name = f"omni thinker --text --moe-offload ({turn + 1})"
        eng, launches, lines, wall_s = run_cli(argv, name)
        check_launches(name, launches, eng, ocfg)
        perf = eng.perf
        if perf.graph_captures or perf.logits_steps != perf.decode_steps or not perf.decode_steps:
            fail(f"{name}: {perf.graph_captures} graphs, {perf.logits_steps} logits steps of "
                 f"{perf.decode_steps} (the host sampler per token expected)")
        texts.append(lines)
        OMNI_RUNS[name] = dict(cli_ms(eng), wall_s=wall_s,
                               router_reads=eng.expert_store.stats["router_reads"])
        log(f"  {name}: {json.dumps(OMNI_RUNS[name])}")
        del eng
        gc.collect()
    if texts[0] != texts[1] or not "".join(texts[0]).strip():
        fail(f"omni thinker --moe-offload: the same seed gave {texts[0]!r} then {texts[1]!r}")
    out["host_memory_gb"] = host_memory()
    log(f"  host memory after the offload runs: {json.dumps(out['host_memory_gb'])}")
    return out


def untied_checkpoint(preset: str, path: str, seed: int) -> str:
    """`preset` written f32 with the full vocab, then given a separate seeded
    lm_head: a tied random head greedy-decodes one token over and over."""
    import torch

    from smolvision_tpu_torch.io.safetensors import MultiSafetensors, write_safetensors
    from smolvision_tpu_torch.models import synthetic

    with mock.patch.dict(synthetic.PRESETS, {OMNI_TINY_PRESET: OMNI_TINY}):
        synthetic.build(preset, path, seed=seed, dtype="f32", full_vocab=True)
    with MultiSafetensors(path) as r:
        tensors = {k: r.get(k).clone() for k in r.names()}
    embed = tensors["thinker.model.embed_tokens.weight"]
    g = torch.Generator().manual_seed(seed + 1000)
    tensors["thinker.lm_head.weight"] = torch.randn(embed.shape, generator=g) * 0.1
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg["thinker_config"]["text_config"]["tie_word_embeddings"] = False
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return path


def phase_tiny_moe_spec(work: str, wav: str) -> dict:
    """--spec --f32 on an untied full-vocab tiny MoE (OMNI_TINY: tiny-moe's
    4 experts top-2 at card head dims; its int8 draft's gathers in the
    iteration's CUDA graph): tokens equal to plain greedy over the whole
    run."""
    import torch

    from smolvision_tpu_torch.io.wav import load_wav
    from smolvision_tpu_torch.runtime.engine import Engine

    path = untied_checkpoint(OMNI_TINY_PRESET, os.path.join(work, OMNI_TINY_PRESET), SEED)
    eng = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32, device=DEV, spec=True)
    eng.set_force_language("English")
    eng.prepare_prompt()
    cmp = spec_vs_plain(eng, load_wav(wav), MAX_TOKENS, exact=True)
    if cmp["spec_iters"] == 0:
        fail(f"{OMNI_TINY_PRESET} --spec --f32: no verify ran")
    OMNI_RUNS[f"{OMNI_TINY_PRESET} --spec --f32"] = cmp
    log(f"  {OMNI_TINY_PRESET} --spec vs plain greedy, f32 (equal over the whole run): "
        f"{json.dumps(cmp)}")
    shutil.rmtree(path, ignore_errors=True)
    return cmp


def omni_int8_kernel_table(shapes, runs: dict) -> list:
    """The kernels line's rows of phase 12's int8 and --spec runs, each
    checked against its plain version on its timing inputs and timed
    (turns plain, kernel, kernel, plain) beside its library call and its
    bound, its launches those of the graph turn of the run that carries
    it: B2 at the 30B --spec verify (T SPEC_DRAFT + 1 at a device start,
    G 8, on the spec run's cache at its last verify's row), K7 over the
    int8 [151936, 2048] head at R 1 (--q8) and at the -S run's batch (-S 20
    --q8), K6 over the bf16 head at the verify's R (--spec)."""
    import torch

    from smolvision_tpu_torch.config import QWEN3_OMNI_30B
    from smolvision_tpu_torch.kernels import argmax_matvec as am
    from smolvision_tpu_torch.runtime import engine as eng_mod

    T = eng_mod.SPEC_DRAFT + 1
    K, start = runs["verify_at"]
    rows = [("causal_cache_attention_omni_verify",
             "smolvision_tpu_torch/kernels/csrc/causal_cache_attention.cu",
             "smolvision_tpu/kernels/flash_attention.py:491",
             *cache_row(T, K, start, start + T, heads=OMNI_HEADS))]
    errs = {rows[0][0]: check_close("causal_cache_attention_omni_verify timing inputs",
                                    rows[0][3](), rows[0][4]())}
    table = timed_table(rows, errs, {})
    table[0]["launches"] = runs["--spec verify"]
    V, Hd = QWEN3_OMNI_30B.vocab_size, QWEN3_OMNI_30B.dec_hidden
    for name, R, kind, run in (("argmax_matvec_q8_omni", 1, "int8", runs["--q8"]),
                               ("argmax_matvec_omni_verify", T, "bfloat16", runs["--spec"]),
                               ("argmax_matvec_q8_omni_batched", shapes["seg_B"], "int8",
                                runs["-S q8"])):
        h, w, scale, _ = head_case(V, Hd, R, kind, 950 + R)
        err = check_head(f"{name} timing inputs", h, w, scale)
        kern = lambda h=h, w=w, s=scale: am.argmax_matvec(h, w, s)   # noqa: E731
        plain = lambda h=h, w=w, s=scale: am.argmax_matvec_plain(h, w, s)   # noqa: E731
        p1, k1, k2, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
        lib_ms = time_ms(head_library(h, w, scale))
        nbytes = w.numel() * w.element_size() + (0 if scale is None else 4 * V) + 4 * R * (Hd + 1)
        bound_ms, bound_by = bound(nbytes, 2.0 * R * V * Hd, kind)
        route = am.head_route(R, w.dtype)
        table.append({"name": name, "route": "cuda",
                      "source": "smolvision_tpu_torch/kernels/csrc/argmax_matvec.cu",
                      "replaces": "tools/probe_int8.py:110" if kind == "int8"
                      else "tools/profile_decode3.py:145",
                      "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "design": route.replace("_", " ") + "s",
                      "launches": run[am.launch_key(route, w.dtype)]})
        log(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); launches "
            f"{table[-1]['launches']}")
        del h, w
    return table


def omni_preflight(path: str) -> None:
    """The 30B checkpoint's size against the free disk and host memory
    (the disk must hold it; the page cache holds what the load reads)."""
    import numpy as np

    from smolvision_tpu_torch.models.synthetic import PRESETS, _specs

    need = sum(int(np.prod(shape)) * (2 if len(shape) >= 2 and "norm" not in name else 4)
               for name, shape, _, _ in _specs(dict(PRESETS[OMNI_PRESET], dec_L=OMNI_LAYERS)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    free = shutil.disk_usage(os.path.dirname(path)).free
    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    log(f"  {OMNI_PRESET}: {need / 1e9:.2f} GB to write; disk free {free / 1e9:.2f} GB, "
        f"host memory available {mem.get('MemAvailable', 0) / 1e9:.2f} GB")
    if need > free:
        fail(f"{OMNI_PRESET}: {need / 1e9:.2f} GB does not fit the {free / 1e9:.2f} GB free")


def phase_omni(omni_dir: str, wav: str, long_wav: str, shapes, build: dict) -> dict:
    """Qwen3-Omni-30B-A3B (seeded bf16, full geometry, resident) through the
    CLI: offline on the 20 s clip, `-S 20` on the 120 s clip (B 6: the
    batched step, dense in its graph), `--stream` on the 20 s clip (the
    prefill graphs, B2 at start > 0) and `--thinker --text` sampled to
    OMNI_TEXT_MAX_TOKENS, each eager then as CUDA graphs with equal tokens
    (`run_path`); the offline decode loop profiled, eager and graph in
    turns; then the forced-overflow forward; then the int8 runs
    (`phase_omni_int8`: --q8, --spec, -S 20 --q8).  The weights are loaded
    once (`resident_weights`), the load timed.  Then, the resident weights
    freed, the host-offload runs (`phase_omni_offload`) on the same
    checkpoint, and --spec --f32 on a small tiny-moe
    (`phase_tiny_moe_spec`)."""
    import gc

    from smolvision_tpu_torch.config import detect_config
    from smolvision_tpu_torch.io.wav import load_wav
    from smolvision_tpu_torch.models.synthetic import PRESETS

    ocfg = detect_config(omni_dir)
    p = PRESETS[OMNI_PRESET]
    if ((ocfg.is_moe, ocfg.dec_layers, ocfg.dec_hidden, ocfg.num_experts, ocfg.enc_layers)
            != (True, OMNI_LAYERS, p["dec_h"], p["moe"]["num_experts"], p["enc_L"])):
        fail(f"{OMNI_PRESET}: detected {ocfg}")
    step = omni_step_bytes(ocfg)
    log(f"  {OMNI_PRESET} decode step bytes: {json.dumps(step)}")
    base = ["-d", omni_dir, "--silent", "--language", "English"]
    out = {"build": build, "step": step}
    with load_timer() as loads, resident_weights():
        eng, launches, lines, _ = run_path(base + ["-i", wav, "--max-tokens", str(MAX_TOKENS)],
                                           "omni offline", ocfg)
        if not eng.dec_params.get("moe_layers") or not all(eng.dec_params["moe_layers"]):
            fail("omni offline: the decoder was not loaded as 48 MoE layers")
        omni_summary("omni offline", eng, step)
        out["offline"] = {"launches": launches, "K": eng._kv_cap,
                          "start": DECODE_RUNS["omni offline"]["last_row"]["graph"]}
        log(f"  omni offline transcript: {' '.join(lines)[:120]}")
        prof = profile_decode(eng, load_wav(wav))
        OMNI_RUNS["omni offline"]["profile"] = {k: v for k, v in prof.items() if k != "windows"}
        log(f"  omni offline decode loop, eager and graph in turns: "
            f"{json.dumps(OMNI_RUNS['omni offline']['profile'])}")
        resident_tokens = greedy_run(eng, load_wav(wav), MAX_TOKENS, spec=False)
        del eng
        gc.collect()
        eng, launches, lines, _ = run_path(
            base + ["-i", long_wav, "-S", str(SEGMENT_SEC), "--max-tokens", str(MAX_TOKENS)],
            "omni -S 20", ocfg, batch=shapes["seg_B"])
        if eng.perf.fresh_prefills == 0 or eng.perf.batch_decode_steps == 0:
            fail("omni -S 20: no batched prefill or decode step ran")
        omni_summary("omni -S 20", eng, step, dense=True)
        out["segments"] = {"launches": launches}
        del eng
        gc.collect()
        with stream_record() as runs:
            eng, launches, lines, wall_s = run_path(
                ["-d", omni_dir, "--language", "English", "--stream", "-i", wav],
                "omni --stream", ocfg)   # not --silent: that is one offline pass
        stream_summary("omni --stream", eng, runs[-1], ocfg, wall_s)
        omni_summary("omni --stream", eng, step)
        del eng
        gc.collect()
        eng, launches, lines, _ = run_path(
            ["-d", omni_dir, "--silent", "--thinker", "--text", THINKER_TEXT, "--max-tokens",
             str(OMNI_TEXT_MAX_TOKENS)], "omni thinker --text", ocfg, loop_kind="sample")
        omni_summary("omni thinker --text", eng, step)
        out["overflow"] = omni_overflow_forward(eng)
        del eng
        gc.collect()
        out["int8"] = phase_omni_int8(omni_dir, wav, long_wav, shapes, ocfg)
    out["offload"] = phase_omni_offload(omni_dir, wav, resident_tokens, ocfg)
    out["tiny_spec"] = phase_tiny_moe_spec(os.path.dirname(omni_dir), wav)
    out["load_s"] = loads[0]
    log(f"  {OMNI_PRESET}: written in {build['build_s']:.1f} s ({build['bytes'] / 1e9:.2f} GB; "
        f"waited for {build['waited_s']:.1f} s since its start), loaded onto the card once in "
        f"{loads[0]:.1f} s (later engines share its weights: "
        f"{', '.join(f'{t:.1f}' for t in loads[1:])} s)")
    return out


def omni_kernel_table(shapes, run: dict, errs: dict) -> list:
    """The kernels line's rows at phase 12's shapes, each checked again on
    its timing inputs and timed (turns plain, kernel, kernel, plain) beside
    its library call and its bound, its launches those of the graph turn of
    the run that carries it: B1 at the 30B encoder's windows of the 20 s
    clip (H 20, D 64), B2 at the offline prefill (G 8), B3 at G 8 at the
    offline run's deepest decode row and cache (all three from the offline
    run), B4 at the -S run's batch (G 8) and K6 over the [151936, 2048]
    head at R 1 (offline) and R 6 (the -S run)."""
    import torch

    from smolvision_tpu_torch.config import QWEN3_OMNI_30B
    from smolvision_tpu_torch.kernels import argmax_matvec as am

    off, seg = run["offline"]["launches"], run["segments"]["launches"]
    WH, WD = OMNI_WINDOW_HEADS
    rows = [("window_attention_omni", "smolvision_tpu_torch/kernels/csrc/window_attention.cu",
             "smolvision_tpu/kernels/flash_attention.py:60",
             *window_row(shapes["window_lens"], H=WH, D=WD)[:4]),
            ("causal_cache_attention_omni",
             "smolvision_tpu_torch/kernels/csrc/causal_cache_attention.cu",
             "smolvision_tpu/kernels/flash_attention.py:491",
             *cache_row(shapes["prefill_T"], shapes["kv_cap"], 0, shapes["prompt_len"],
                        heads=OMNI_HEADS)),
            ("decode_attention_omni", "smolvision_tpu_torch/kernels/csrc/decode_attention.cu",
             "smolvision_tpu/kernels/flash_attention.py:184",
             *decode_row(run["offline"]["K"], run["offline"]["start"], heads=OMNI_HEADS)),
            ("batched_causal_attention_omni",
             *batched_causal_row(shapes["seg_B"], shapes["seg_T"], shapes["seg_pads"],
                                 OMNI_HEADS)[:-1])]
    row_errs = dict(errs)
    for name, _, _, kern, plain, _, _ in rows:
        row_errs[name] = max(errs[kernel_of(name)], check_close(f"{name} timing inputs",
                                                                kern(), plain()))
    table = timed_table(rows, row_errs, {})
    launches = {"window_attention_omni": off["window_attention"],
                "causal_cache_attention_omni": off["causal_cache_attention"],
                "decode_attention_omni": off["decode_attention"],
                "batched_causal_attention_omni": seg["batched_causal_attention"]}
    V, Hd = QWEN3_OMNI_30B.vocab_size, QWEN3_OMNI_30B.dec_hidden
    for name, R, source_run in (("argmax_matvec_omni", 1, off),
                                ("argmax_matvec_omni_batched", shapes["seg_B"], seg)):
        h, w, _, _ = head_case(V, Hd, R, "bfloat16", 900 + R)
        err = max(errs["argmax_matvec"], check_head(f"{name} timing inputs", h, w))
        hb = h.to(torch.bfloat16)
        kern = lambda h=h, w=w: am.argmax_matvec(h, w)   # noqa: E731
        plain = lambda h=h, w=w: am.argmax_matvec_plain(h, w)   # noqa: E731
        p1, k1, k2, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
        lib_ms = time_ms(lambda hb=hb, w=w: torch.argmax(
            torch.mm(hb, w.t(), out_dtype=torch.float32), dim=-1))
        nbytes = w.numel() * w.element_size() + 4 * R * (Hd + 1)
        bound_ms, bound_by = bound(nbytes, 2.0 * R * V * Hd, "bfloat16")
        route = am.head_route(R, w.dtype)
        table.append({"name": name, "route": "cuda",
                      "source": "smolvision_tpu_torch/kernels/csrc/argmax_matvec.cu",
                      "replaces": "tools/profile_decode2.py:127" if R == 1
                      else "tools/profile_decode3.py:145",
                      "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "design": route.replace("_", " ") + "s"})
        launches[name] = source_run[am.launch_key(route, w.dtype)]
        log(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del h, w, hb
    for row in table:
        row["launches"] = launches[row["name"]]
    return table



# ---------------------------------------------------------------------------
# phase 13: the device mesh (parallel/mesh.py) on torch.distributed
# ---------------------------------------------------------------------------

MESH_TP_HEADS = (8, 4, 128)   # (H, KH, D) of a 0.6B rank at tp 2
MESH_LIMIT_S = 300            # the two-rank spawn's wall clock; past it its ranks are killed
MESH_RUNS = {}


def mesh_worker():
    """tests/torch_mesh_worker.py (a rank of the mesh runs, and their
    launcher), loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_mesh_worker", os.path.join(ROOT, "tests", "torch_mesh_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_segments(samples):
    """The -S 20 path's segments of `samples` (runtime/segment.transcribe_audio)."""
    import numpy as np

    from smolvision_tpu_torch.config import SAMPLE_RATE
    from smolvision_tpu_torch.runtime.segment import split_points

    splits = split_points(samples, SEGMENT_SEC, 3.0)
    segs = [samples[a:b] for a, b in zip(splits, splits[1:])]
    n = SAMPLE_RATE // 2
    return [np.concatenate([s, np.zeros(n - len(s), np.float32)]) if len(s) < n else s
            for s in segs]


def mesh_recorded(eng, run):
    """run() as the paths ship (graph mode), its launch counts and engine
    counters reset first: (its result, the graphs' (kind, launches per
    replay), the launches, the loop captures)."""
    from smolvision_tpu_torch.kernels import ffi

    eng.perf.reset()
    ffi.reset_launch_counts()
    with decode_mode("graph") as rec:
        out = run()
    return out, rec["graphs"], dict(ffi.launch_counts), eng.perf.graph_captures


def phase_mesh_world1(model_dir: str, segs, serve_clips, work: str) -> dict:
    """World size 1 over nccl, mesh (1, 1), the 0.6B in bf16: -S 20's
    segments and --serve 4's clips through shard_engine give the unsharded
    engine's token rows, graph captures, launches per replay and launch
    counts, in the same call."""
    import torch
    import torch.distributed as dist

    from smolvision_tpu_torch.parallel import mesh as mesh_mod
    from smolvision_tpu_torch.runtime import batch_segments, serving
    from smolvision_tpu_torch.runtime.engine import Engine

    eng = Engine(model_dir, device=DEV)
    eng.set_force_language("English")
    runs = {}
    for sharded in (False, True):
        if sharded:
            dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous-world1",
                                    rank=0, world_size=1)
            mesh = mesh_mod.make_mesh(tp=1, device=torch.device(DEV, 0))
            mesh_mod.shard_engine(eng, mesh)
            if eng.serving_mesh is not mesh or mesh_mod.mesh_dp(mesh) != 1:
                fail("phase 13: shard_engine did not put the engine on the (1, 1) mesh")
        eng.max_tokens = MAX_TOKENS
        seg = mesh_recorded(eng, lambda: batch_segments.decode_segments_batched(eng, segs))
        eng.max_tokens = SERVE_MAX_TOKENS
        serve = mesh_recorded(eng, lambda: serving.decode_continuous(eng, serve_clips,
                                                                       SERVE_SLOTS))
        runs[sharded] = {"-S 20": seg, "--serve 4": serve}
    dist.destroy_process_group()
    out = {}
    for path in ("-S 20", "--serve 4"):
        plain, meshed = runs[False][path], runs[True][path]
        for i, what in enumerate(("token rows", "graphs and launches per replay",
                                  "launch counts", "graph captures")):
            if plain[i] != meshed[i]:
                fail(f"phase 13, world size 1 {path}: the (1, 1) mesh's {what} differ from "
                     f"the unsharded engine's: {meshed[i]} vs {plain[i]}")
        if not plain[3] or not any(k == "decode" for k, _ in plain[1]):
            fail(f"phase 13, world size 1 {path}: no decode graph was captured")
        out[path] = {"rows": len(plain[0]), "tokens": sum(len(r) for r in plain[0]),
                     "graph_captures": plain[3], "graphs": plain[1], "launches": plain[2]}
    return out


def phase_mesh_world2(model_dir: str, segs, serve_clips, work: str) -> dict:
    """World size 2 over gloo, both ranks on cuda:0 (tests/torch_mesh_worker.py
    ranks), f32 weights: --serve 4 at (dp 2, tp 1), -S 20 and --serve 4 at
    (1, 2) on the 0.6B, and --serve 4 at (1, 2) on a small untied MoE (its
    experts split over "model": expert parallelism); each rank's token rows
    must equal one process's, and each rank's launches its own bookkeeping
    at its share (its rows; its heads, KV heads and vocabulary rows)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from smolvision_tpu_torch.config import detect_config
    from smolvision_tpu_torch.runtime import batch_segments, serving
    from smolvision_tpu_torch.runtime.engine import Engine
    ranks_mod = mesh_worker()
    start_ranks, finish_ranks = ranks_mod.start_ranks, ranks_mod.finish_ranks

    moe_dir = untied_checkpoint(OMNI_TINY_PRESET, os.path.join(work, OMNI_TINY_PRESET), SEED)
    ranks_dir = os.path.join(work, "mesh_ranks")
    os.makedirs(ranks_dir, exist_ok=True)
    np.savez(os.path.join(ranks_dir, "serve.npz"), **{str(i): c for i, c in enumerate(serve_clips)})
    np.savez(os.path.join(ranks_dir, "segs.npz"), **{str(i): c for i, c in enumerate(segs)})
    serve = {"kind": "serve", "audio": os.path.join(ranks_dir, "serve.npz"), "slots": SERVE_SLOTS,
             "language": "English", "settings": {"max_tokens": SERVE_MAX_TOKENS}}
    cases = [dict(serve, name="serve_dp", model=model_dir, mesh=[2, 1]),
             {"name": "segments_tp", "kind": "segments", "model": model_dir, "mesh": [1, 2],
              "audio": os.path.join(ranks_dir, "segs.npz"), "language": "English",
              "settings": {"max_tokens": MAX_TOKENS}},
             dict(serve, name="serve_tp", model=model_dir, mesh=[1, 2]),   # segments_tp's engine
             dict(serve, name="serve_moe", model=moe_dir, mesh=[1, 2])]
    t0 = time.monotonic()
    procs = start_ranks({"cases": cases, "device": f"{DEV}:0", "threads": 2}, ranks_dir)
    try:
        want = {}
        for path, name in ((model_dir, "0.6b"), (moe_dir, OMNI_TINY_PRESET)):
            eng = Engine(path, param_dtype=torch.float32, kv_dtype=torch.float32, device=DEV)
            eng.set_force_language("English")
            eng.max_tokens = SERVE_MAX_TOKENS
            want[(name, "serve", SERVE_MAX_TOKENS)] = serving.decode_continuous(
                eng, serve_clips, SERVE_SLOTS)
            if name == "0.6b":
                eng.max_tokens = MAX_TOKENS
                want[(name, "segments", MAX_TOKENS)] = batch_segments.decode_segments_batched(
                    eng, segs)
            del eng
        ref_s = time.monotonic() - t0
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = finish_ranks(procs, ranks_dir, MESH_LIMIT_S)
    wall_s = time.monotonic() - t0
    expect = {"serve_dp": ("0.6b", "serve", SERVE_MAX_TOKENS),
              "segments_tp": ("0.6b", "segments", MAX_TOKENS),
              "serve_tp": ("0.6b", "serve", SERVE_MAX_TOKENS),
              "serve_moe": (OMNI_TINY_PRESET, "serve", SERVE_MAX_TOKENS)}
    cfgs = {"0.6b": detect_config(model_dir), OMNI_TINY_PRESET: detect_config(moe_dir)}
    f32_head = {"lm_head": torch.empty(0, dtype=torch.float32)}
    out = {}
    for name, (model, path, _) in expect.items():
        rows = want[expect[name]]
        S, _ = serving_widths(len(serve_clips), SERVE_SLOTS)
        dp = 2 if name == "serve_dp" else 1
        for r, rank in enumerate(ranks):
            got = rank[name]
            if got["rows"] != rows:
                first = next(i for i, (a, b) in enumerate(zip(got["rows"], rows)) if a != b)
                fail(f"phase 13, {name}: rank {r}'s token rows differ from one process's "
                     f"(first at row {first}: {got['rows'][first][:16]} vs {rows[first][:16]})")
            if any(k != "argmax_matvec" and "argmax" in k and n for k, n in
                   got["launches"].items()):
                fail(f"phase 13, {name}: an f32 head took another route: {got['launches']}")
            fake = SimpleNamespace(perf=SimpleNamespace(**got["perf"]), dec_params=f32_head,
                                   spec=False, kv8=False)
            # a rank's head runs on its rows: S / dp slots, the wave's rows whole
            check_launches(f"phase 13 {name} rank {r}", got["launches"], fake, cfgs[model],
                           batch=len(segs) if path == "segments" else S // dp,
                           wave=S if path == "serve" else 0)
        perf = ranks[0][name]["perf"]
        out[name] = {"tokens": sum(len(r) for r in rows),
                     "decode_ms_per_step": perf["batch_decode_ms"]
                     / max(perf["batch_decode_steps"], 1),
                     "launches_rank0": {k: n for k, n in ranks[0][name]["launches"].items()
                                        if n},
                     "graph_captures": [rank[name]["perf"]["graph_captures"] for rank in ranks],
                     "rank_s": [round(rank[name]["seconds"], 3) for rank in ranks]}
        if name != "serve_dp" and any(rank[name]["perf"]["graph_captures"] for rank in ranks):
            fail(f"phase 13, {name}: a tp 2 step was captured (it holds collectives)")
    if not all(rank["serve_dp"]["perf"]["graph_captures"] for rank in ranks):
        fail("phase 13, serve_dp: a dp 2 rank captured no decode graph")
    log(f"  two ranks sharing one card over gloo -- not a mesh speed: wall {wall_s:.2f} s "
        f"(one process's references {ref_s:.2f} s meanwhile); per case and rank: "
        f"{json.dumps({k: v['rank_s'] for k, v in out.items()})}; decode ms per step "
        f"(rank 0): {json.dumps({k: v['decode_ms_per_step'] for k, v in out.items()})}")
    shutil.rmtree(moe_dir, ignore_errors=True)
    return out


def mesh_kernel_table(cfg, shapes, launches: dict) -> list:
    """B4 and B5 at a 0.6B rank's tp 2 heads (H 8, KH 4) at the -S 20 and
    --serve 4 shapes, and K6 over a tp 2 vocabulary shard [V / 2, H]
    returning keys at the -S 20 batch's rows, each held against its plain
    version (K6: indices of planted winners equal, values within
    HEAD_RTOL) and timed beside SDPA / argmax(mm) and its bound; launches
    from the world size 2 runs."""
    import torch

    from smolvision_tpu_torch.kernels import argmax_matvec as am

    errs = {}
    B4, T4, pads4 = shapes["seg_B"], shapes["seg_T"], shapes["seg_pads"]
    G5, T5, lens5 = shapes["serve_G"], shapes["serve_T"], shapes["serve_lens"]
    row4 = batched_causal_row(B4, T4, pads4, heads=MESH_TP_HEADS)
    row5 = batched_cache_row(G5, T5, lens5, heads=MESH_TP_HEADS)
    for name, row in (("batched_causal_attention_tp2", row4),
                      ("batched_cache_attention_tp2", row5)):
        errs[name] = check_close(f"{name} H={MESH_TP_HEADS[0]} KH={MESH_TP_HEADS[1]}",
                                 row[2](), row[3]())
    V, H, R = cfg.vocab_size // 2, cfg.dec_hidden, B4
    h, w, _, winners = head_case(V, H, R, "float32", 300, planted=True)
    offset = V
    keys = am.argmax_matvec(h, w, offset=offset)
    plain = am.argmax_matvec_plain(h, w, offset=offset)
    if am.key_index(keys).tolist() != [v + offset for v in winners] or \
            am.key_index(plain).tolist() != am.key_index(keys).tolist():
        fail("phase 13: K6's keys at a vocabulary offset do not index the planted winners")
    values = [((k >> 32).to(torch.int32)) for k in (keys, plain)]
    values = [torch.where(v < 0, v ^ 0x7FFFFFFF, v).view(torch.float32) for v in values]
    errs["argmax_matvec_tp2"] = float((values[0] - values[1]).abs().max())
    if errs["argmax_matvec_tp2"] > HEAD_RTOL * float(values[1].abs().max()):
        fail(f"phase 13: K6's key values differ from the plain packing by "
             f"{errs['argmax_matvec_tp2']:.3g}")
    nbytes = 4 * (w.numel() + h.numel()) + 8 * R
    rows = [("batched_causal_attention_tp2", *row4[:-1]),
            ("batched_cache_attention_tp2", *row5[:-1]),
            ("argmax_matvec_tp2", "smolvision_tpu_torch/kernels/csrc/argmax_matvec.cu",
             "tools/profile_decode3.py:145",
             lambda: am.argmax_matvec(h, w, offset=offset),
             lambda: am.argmax_matvec_plain(h, w, offset=offset),
             lambda: torch.argmax(h @ w.t(), dim=-1),
             bound(nbytes, 2.0 * R * V * H, "float32"))]
    table = timed_table(rows, errs, {})
    for t in table:
        t["launches"] = launches[t["name"]]
    return table


def phase_mesh(model_dir: str, long_clip, serve_clips, work: str, shapes, cfg) -> list:
    """Phase 13: the mesh at world size 1 (nccl) and 2 (gloo, one card), and
    the kernels at a tp 2 rank's shapes.  Returns the kernels line's rows."""
    t0 = time.monotonic()
    segs = mesh_segments(long_clip)
    if len(segs) != shapes["seg_B"]:
        fail(f"phase 13: {len(segs)} segments, the -S 20 path has {shapes['seg_B']}")
    MESH_RUNS["world size 1, nccl, (1, 1), bf16"] = phase_mesh_world1(model_dir, segs,
                                                                      serve_clips, work)
    two = phase_mesh_world2(model_dir, segs, serve_clips, work)
    MESH_RUNS["world size 2, gloo on one card, f32"] = two
    launches = {"batched_causal_attention_tp2":
                    two["segments_tp"]["launches_rank0"].get("batched_causal_attention", 0),
                "batched_cache_attention_tp2":
                    two["serve_tp"]["launches_rank0"].get("batched_cache_attention", 0),
                "argmax_matvec_tp2": two["segments_tp"]["launches_rank0"].get("argmax_matvec",
                                                                              0)}
    table = mesh_kernel_table(cfg, shapes, launches)
    MESH_RUNS["seconds"] = time.monotonic() - t0
    log(f"phase 13 (mesh): {MESH_RUNS['seconds']:.2f} s")
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
    global CARD_LINE, F32_LOGIT_DIFF, NATIVE_BUILD
    CARD_LINE = smi_line
    log(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi_line}")
    q25_dir = os.path.join(ROOT, "build", "chip_smoke_q25", Q25_PRESET)
    omni_dir = os.path.join(ROOT, "build", "chip_smoke_omni", OMNI_PRESET)
    for d in (q25_dir, omni_dir):
        shutil.rmtree(os.path.dirname(d), ignore_errors=True)
    q25_build = omni_build = None
    if not args.kernels_only:
        # phase 11's checkpoint, written while phases 2-10 run
        q25_build = CheckpointBuild(Q25_PRESET, q25_dir, SEED)
        log(f"{Q25_PRESET}: writing a seeded bf16 checkpoint in a child process")

    # phase 2: build
    from smolvision_tpu_torch.kernels import build

    t0 = time.monotonic()
    logs = build.build_all()
    log(f"build: {time.monotonic() - t0:.2f} s ({len(logs)} libraries)")
    for entry in logs:
        for line in entry.ptxas.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{entry.name}] {line.strip()}")
    # the host runtime library (gcc), before anything encodes a prompt
    from smolvision_tpu_torch.utils import native

    t0 = time.monotonic()
    NATIVE_BUILD = {"cached": native.lib_path().exists()}
    native.build()
    NATIVE_BUILD["seconds"] = time.monotonic() - t0
    log(f"host runtime library (gcc): {json.dumps(NATIVE_BUILD)}")
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
        shapes.update(q25_path_shapes(model_dir, samples))
        log(f"attention shapes of the paths: {json.dumps(shapes)}")

        # phase 3: kernels vs plain versions
        from smolvision_tpu_torch.config import detect_config

        cfg = detect_config(model_dir)
        table = phase_kernels(shapes) + phase_heads(cfg, shapes["seg_B"])
        q25_errs = phase_q25_kernels(shapes)
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

        # phase 8: --serve 64 and --serve 64 --q8 (the heads on the tensor
        # cores), then --serve 16 (four waves at one wave graph key)
        wide_runs = phase_serving_wide(model_dir, wide_wavs, cfg, shapes["wide_T"])
        wave_launches = phase_serving_waves(model_dir, wide_wavs, cfg)
        since("phase 8 (--serve 64, --serve 16)")

        # phase 9: --stream, --stdin --stream, --enc-window-sec, --profile
        stream_run = phase_stream(model_dir, stream_wavs, cfg)
        since("phase 9 (--stream)")

        # phase 10: --stream with several -i files (multistream: B1 batched
        # over the sessions' spans, B5 at start > 0, K6 / K7 at R = B)
        mstream_run = phase_multistream(model_dir, mstream_wavs, cfg)
        table += mstream_b5_table(mstream_run["b5_runs"], cfg.dec_layers)
        since("phase 10 (multistream)")

        # phase 14: the front end: device log-mel against host mel, -S 20 on
        # both, mel ms both ways, --sampler cref on both expf routes
        phase_frontend(model_dir, long_clip, wide_clips, clip, mstream_run["mel_rounds"])
        since("phase 14 (front end)")

        # phase 11: the thinker (0.6B: greedy, sampled, cref) and
        # Qwen2.5-Omni-7B (the ASR route, the greedy and the text thinker)
        long = phase_thinker(model_dir, wav, cfg)
        since("phase 11, 0.6B thinker")
        q25_run = phase_q25(q25_dir, wav, q25_build.wait())
        table += q25_kernel_table(shapes, q25_run, long, q25_errs)
        since("phase 11 (thinker, Qwen2.5-Omni-7B)")

        # phase 12: Qwen3-Omni-30B-A3B resident; its checkpoint is written
        # once q25-7b's is gone (the disk does not hold both), while the
        # kernels are checked at its shapes
        shutil.rmtree(os.path.dirname(q25_dir), ignore_errors=True)
        omni_preflight(omni_dir)
        omni_build = CheckpointBuild(OMNI_PRESET, omni_dir, SEED, device=DEV,
                                     timeout_s=OMNI_BUILD_TIMEOUT_S, dec_layers=OMNI_LAYERS)
        log(f"{OMNI_PRESET}: writing a seeded bf16 checkpoint in a child process (drawn on the "
            f"card)")
        omni_errs = phase_omni_kernels(shapes)
        omni_run = phase_omni(omni_dir, wav, long_wav, shapes, omni_build.wait())
        table += omni_kernel_table(shapes, omni_run, omni_errs)
        table += omni_int8_kernel_table(shapes, omni_run["int8"])
        since("phase 12 (Qwen3-Omni-30B-A3B)")
        shutil.rmtree(os.path.dirname(omni_dir), ignore_errors=True)

        # phase 13: the device mesh at world size 1 (nccl) and 2 (gloo ranks
        # sharing the card), and the kernels at a tp 2 rank's shapes
        table += phase_mesh(model_dir, long_clip, serve_clips, work, shapes, cfg)
        since("phase 13 (mesh)")
    finally:
        for child in (q25_build, omni_build):
            if child is not None:
                child.stop()
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(os.path.dirname(q25_dir), ignore_errors=True)
        shutil.rmtree(os.path.dirname(omni_dir), ignore_errors=True)

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
                    batched_cache_attention_wave=serve_launches["batched_cache_attention"],
                    batched_cache_attention_wave16=wave_launches["batched_cache_attention"],
                    batched_cache_attention_wave_wide=wide_runs["bf16"][
                        "batched_cache_attention"],
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
    log(f"thinker runs [{smi_line}]: {json.dumps(THINKER_RUNS)}")
    log(f"omni-30b runs [{smi_line}]: {json.dumps(OMNI_RUNS)}")
    omni_int8 = {k: v for k, v in OMNI_RUNS.items()
                 if any(f in k for f in ("--q8", "--spec", "--moe-offload"))}
    omni_int8["link"] = omni_run["offload"]["link"]
    omni_int8["host_memory_gb"] = omni_run["offload"]["host_memory_gb"]
    log(f"omni-30b --q8 / --spec / --moe-offload [{smi_line}]: {json.dumps(omni_int8)}")
    log(f"mesh runs [{smi_line}]: {json.dumps(MESH_RUNS)}")
    log(f"--serve {SERVE_WAVE_SLOTS} waves [{smi_line}]: {json.dumps(SERVE_WAVE_RUN)}")
    log(f"decode loops, graph vs eager per path: {json.dumps(DECODE_RUNS)}")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in table]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
