"""Multistream: N concurrent streaming ASR sessions on one card (port of
smolvision_tpu/runtime/multistream.py, `--stream` with several `-i` files).

The expensive state -- the weights on the card, the tokenizer -- is shared
by all sessions; each session gets a lightweight view of the engine
(`clone_session`: its own KV cache, decode loop, perf counters, callback
and streaming state).  Two modes:

  * BATCHED (default for two or more preloaded or live sources): sessions
    advance chunk by chunk on a shared clock.  Each keeps its own
    StreamState (runtime/stream.py: encoder window cache, commit frontier,
    recovery); the coordinator replaces only the model calls in the middle
    of each chunk.  Per round:
      - the sessions' new encoder windows and partial tails are encoded as
        one batch (`_pre_encode_round`: host mel, one conv stem call and
        one kernel-B1 launch per layer for all spans), handed to
        begin_chunk through StreamState's `_pre_windows` / `_pre_tail`;
      - one batched delta prefill for all sessions (kernel B5 against the
        batched cache at start S > 0 once every row reuses 64 rows or
        more, per-row prompt_max, region_start = pcap; the two-part
        attention on an int8 cache under --kv8);
      - one batched greedy decode of up to stream_max_new_tokens steps in
        the shared decode region, replaying the CUDA graph of the batched
        step (runtime/decode_graph.py).  The graph holds the cache: one
        loop, so one capture, per cache tensor (first allocation, growth
        of the prompt cap, compaction), never one per round.
    Sessions keep a fixed row of the round-persistent cache (`_BatchKV`,
    natural layout), so kept prompt rows never move and only the block
    below the shallowest reuse point is prefilled again.  Per-session
    tokens equal a solo run's: greedy argmax is deterministic and the
    batched decoder gives the sequential one's tokens (held on the CPU by
    tests/test_torch_multistream.py).  Rows of drained sessions are
    compacted away when the power-of-two row bucket halves.
  * THREADED (a single source, or SMOLVISION_BATCH_STREAMS=0): one host
    thread per session, each running the single-stream path on its view.
    The sessions take turns on the card one chunk at a time (a lock held
    from begin_chunk to the chunk's last host read), so no two sessions'
    device work overlaps: a decode-graph capture never meets another
    thread's launches, syncs or allocations (CUDA's default capture mode
    refuses them), and the kernels' launch counts never race.  The JAX
    package's threaded mode is likewise bounded by one stream of
    dispatches.

Left out of the port, as in the JAX package off its TPU backend or by
choice (ROADMAP.md): the compile prewarm ladder (`_prewarm_batched`, a
no-op off the TPU), the opt-in stratified reset-row prefill
(SMOLVISION_MSTREAM_STRAT=1), the device mesh rows (`serving_mesh`), the
device-mel pre-encode, and MoE sessions.

Switches, as the JAX package reads them, each the degraded path a test
compares the default against: SMOLVISION_MSTREAM_NO_REUSE=1 (full prefill
every round) and SMOLVISION_MSTREAM_SOLO_BATCHED=0 (a round with one
session runs the single-stream path).  The delta block is always
quantized (`quantize_block`) and the round's spans always pre-encoded as
one batch.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from smolvision_tpu_torch.config import EOS_TOKEN_IDS
from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.ops.quant import kv_rows_gather
from smolvision_tpu_torch.parallel import batch as pbatch
from smolvision_tpu_torch.runtime import stream as stream_mod
from smolvision_tpu_torch.runtime.batch_segments import BATCH_DECODE_CHUNK, _encode_batch, _now_ms
from smolvision_tpu_torch.runtime.buckets import bucket, bucket128
from smolvision_tpu_torch.runtime.engine import PerfStats

MIN_ROWS = 2   # the batched cache's smallest row bucket


def clone_session(engine):
    """A lightweight engine view for one session: shares the weights,
    tokenizer and generation settings; owns its KV cache (and so its
    decode loop), perf counters and callback."""
    _ = engine.tokenizer          # load once; views share it
    engine.prepare_prompt()
    s = copy.copy(engine)
    s.perf = PerfStats()
    s.token_cb = None
    s.reset_kv()
    return s


class StreamSession:
    """One streaming transcription bound to a session engine view, run in a
    thread of its own (the threaded mode): each chunk's device work holds
    `turn`, the lock its sessions share."""

    def __init__(self, engine, source, turn: threading.Lock,
                 on_token: Optional[Callable[[bytes], None]] = None):
        """source: np.ndarray of samples (preloaded audio, streamed in 2 s
        chunks) or a LiveAudio-like object (io/live.py protocol)."""
        self.engine = clone_session(engine)
        # a session streams chunk by chunk even for preloaded audio (the
        # silent-mode one-pass shortcut is the single-stream CLI's), so it
        # always has a callback
        self.engine.token_cb = on_token if on_token is not None else (lambda piece: None)
        self.source = source
        self.turn = turn
        self.text: Optional[str] = None
        self.error: Optional[BaseException] = None

    def run(self):
        """runtime/stream.py's chunk loop, a chunk per turn; a live source is
        polled (`nowait`), so a session waiting for audio holds no turn."""
        try:
            live = None if isinstance(self.source, np.ndarray) else self.source
            state = stream_mod.StreamState(self.engine, self.source if live is None else None,
                                           live)
            state.nowait = live is not None
            while state.active():
                with self.turn:
                    w = state.begin_chunk()
                    if w is not None and w is not stream_mod.NOT_READY:
                        stream_mod.run_solo_chunk(state, w)
                if w is stream_mod.NOT_READY:
                    time.sleep(0.005)   # the live buffer is filling
            self.text = state.finalize()
        except BaseException as e:  # re-raised by run_streams in the caller's thread
            self.error = e


def _live_like(s) -> bool:
    """The io/live.py protocol plus the non-blocking poll the coordinator needs."""
    return hasattr(s, "snapshot_and_reset") and hasattr(s, "available_through")


def run_streams(engine, sources: Sequence, on_token=None) -> List[Optional[str]]:
    """Run one streaming session per source concurrently; returns the final
    texts in source order.

    Two or more preloaded arrays or live sources go through the batched
    coordinator (`run_streams_batched`); one source, or
    SMOLVISION_BATCH_STREAMS=0, runs one host thread per session.  They run
    on the engine's device: the card, unless the engine was built on the
    CPU on request.

    on_token: optional callable (session_index, piece_bytes) invoked as
    text commits (from the session threads in the threaded mode).
    """
    batched_ok = (len(sources) > 1
                  and all(isinstance(s, np.ndarray) or _live_like(s) for s in sources)
                  and os.environ.get("SMOLVISION_BATCH_STREAMS", "") != "0")
    if batched_ok:
        return run_streams_batched(engine, sources, on_token)

    turn = threading.Lock()
    sessions = []
    for i, src in enumerate(sources):
        cb = (lambda piece, _i=i: on_token(_i, piece)) if on_token else None
        sessions.append(StreamSession(engine, src, turn, cb))
    threads = [threading.Thread(target=s.run, name=f"stream-{i}", daemon=True)
               for i, s in enumerate(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in sessions:
        if s.error is not None:
            raise s.error
    return [s.text for s in sessions]


# ---------------------------------------------------------------------------
# Batched coordinator
# ---------------------------------------------------------------------------


class _BatchKV:
    """Round-persistent batched KV cache in the NATURAL layout: each session
    owns a fixed row, and its prompt KV lives at its logical positions
    [0, lens[r]) -- rows never move between rounds.  The shared decode
    region sits at [pcap, kcap): every round's bounded decode writes there
    batch-uniformly and is overwritten next round.  End-pad garbage in
    [lens[r], pcap) is masked out of attention via prompt_max.  Growing
    pcap is ONE contiguous block copy (positions are absolute), preserving
    reuse.

    valid[r]: row r's kept rows match its session's last prompt signature
    (cleared when the session runs solo, or skips a round -- the shared
    block write clobbers its rows -- or has not taken part yet).

    `loop` is the batched decode loop of `kv` (its CUDA graph writes into
    that tensor): dropped whenever `kv` is replaced.  The rest is the run's
    record: caches allocated (first allocation, growths, compactions) and
    one entry per round (`rounds`)."""

    def __init__(self, n_sessions: int):
        self.B = max(MIN_ROWS, 1 << (max(1, n_sessions) - 1).bit_length())
        self.kv = None
        self.loop = None
        self.pcap = 0
        self.kcap = 0
        self.lens = [0] * self.B
        self.valid = [False] * self.B
        self.caches = 0
        self.grows = 0
        self.compactions = 0
        self.rounds: List[dict] = []

    def record(self) -> dict:
        return {"caches": self.caches, "grows": self.grows, "compactions": self.compactions,
                "rounds": self.rounds}


@torch.inference_mode()
def run_streams_batched(engine, sources: Sequence, on_token=None) -> List[Optional[str]]:
    """Advance all sessions chunk by chunk on a shared clock, batching each
    round's prefills and bounded decodes through the batched decoder.

    Every session keeps its own StreamState; only the model-call middle of
    each chunk is replaced.  The batched middle reuses each session's KV
    across rounds (`_BatchKV`, natural layout): only the block below the
    shallowest per-row reuse point is prefilled again (exact by greedy
    determinism -- rows with deeper reuse recompute a few kept rows into
    the same values), and the bounded decodes run in a shared decode
    region past the prompt cap.  SMOLVISION_MSTREAM_NO_REUSE=1 forces a
    full prefill every round.  The run's record (rounds, caches) is left
    in engine.perf.multistream.
    """
    states = []
    for i, src in enumerate(sources):
        view = clone_session(engine)
        view.token_cb = (lambda piece, _i=i: on_token(_i, piece)) if on_token else (
            lambda piece: None)
        if isinstance(src, np.ndarray):
            states.append(stream_mod.StreamState(view, np.asarray(src, np.float32), None))
        else:
            # a LIVE source on the shared clock: the session polls its buffer
            # (nowait) and reports NOT_READY instead of blocking the round
            st = stream_mod.StreamState(view, None, src)
            st.nowait = True
            states.append(st)

    cache = _BatchKV(len(states))
    row_of = {id(st): r for r, st in enumerate(states)}
    solo_batched = os.environ.get("SMOLVISION_MSTREAM_SOLO_BATCHED", "1") != "0"
    solo_kv_valid = set()   # sessions whose own single-stream cache holds their prompt
    while True:
        t_round = _now_ms()
        act = [st for st in states if st.active()]
        _compact_rows(cache, row_of, act)
        pre_encode_ms = _pre_encode_round(engine, act) if len(act) > 1 else 0.0
        works = []
        n_pending = 0
        for st in act:
            w = st.begin_chunk()
            if w is stream_mod.NOT_READY:
                n_pending += 1
                continue
            if w is not None:
                works.append((st, w))
        if not works:
            if not any(st.active() for st in states):
                break
            if n_pending:
                time.sleep(0.005)   # live buffers filling; don't spin
            continue
        if len(works) == 1 and not solo_batched:
            # the single-stream path for a round with one session (opt-in:
            # the default runs it through the batched machinery with pad
            # rows, which keeps its row's KV reuse in both directions)
            st, w = works[0]
            if id(st) not in solo_kv_valid:
                # every earlier round of this session ran in the batched
                # cache: its view's own cache has never seen this prompt,
                # so reset it and prefill fully; later consecutive solo
                # rounds reuse normally
                st.engine.reset_kv()
                w.reused = 0
                solo_kv_valid.add(id(st))
            cache.valid[row_of[id(st)]] = False   # the batched row is now stale
            stream_mod.run_solo_chunk(st, w)
            continue
        solo_kv_valid.difference_update(id(st) for st, _ in works)
        _run_batched_chunks(engine, works, cache, row_of)
        cache.rounds[-1].update(pre_encode_ms=pre_encode_ms, wall_ms=_now_ms() - t_round)
    engine.perf.multistream = cache.record()
    return [st.finalize() for st in states]


def _compact_rows(cache: _BatchKV, row_of: dict, act_states) -> None:
    """Shrink the batch bucket when enough sessions have drained.

    Mixed-duration fleets otherwise keep paying the original B for every
    decode step after short sessions finish.  The surviving sessions' rows
    are copied into a fresh smaller cache (`kv_rows_gather`: a block copy
    per row, never a view of the old cache, which the held decode graph
    writes into) and renumbered 0..n-1; only when the power-of-two bucket
    halves, so at most log2(B) compactions per run."""
    n = len(act_states)
    if n == 0 or cache.kv is None:
        return
    new_b = max(MIN_ROWS, 1 << (n - 1).bit_length())
    if new_b >= cache.B:
        return
    keep = [row_of[id(st)] for st in act_states]
    while len(keep) < new_b:          # pad rows: duplicate row 0 (garbage)
        keep.append(keep[0])
    cache.kv = kv_rows_gather(cache.kv, keep)
    cache.loop = None
    cache.caches += 1
    cache.compactions += 1
    cache.lens = [cache.lens[r] for r in keep]
    cache.valid = [cache.valid[r] for r in keep]
    for i in range(len(act_states), new_b):
        cache.valid[i] = False
    cache.B = new_b
    row_of.clear()
    for i, st in enumerate(act_states):
        row_of[id(st)] = i


def _pre_encode_round(engine, states) -> float:
    """Batch the round's encoder work across sessions.

    begin_chunk encodes each session's newly completed windows and its
    partial tail one call each.  For preloaded audio the spans each session
    will encode are known ahead (the cursor advance is arithmetic), so the
    coordinator encodes ALL of them as one batch (host mel per span, then
    runtime/batch_segments._encode_batch: one conv-stem call, one kernel-B1
    launch per layer) and hands the results to begin_chunk through its
    span-checked `_pre_windows` / `_pre_tail`; a span it did not predict is
    encoded there as before.  Returns its ms (0 when it encoded nothing)."""
    reqs = []   # (state, key, samples)
    for st in states:
        if st.live is not None or not st.use_enc_cache:
            continue
        cursor = min(st.audio_cursor + st.chunk_samples, st.total_samples)
        ews = st.enc_window_samples
        full_end = (cursor // ews) * ews
        ws = st.enc_cache.next_window_start
        while ws < full_end:
            lo = ws - st.local_base
            if lo < 0 or lo + ews > len(st.local):
                break
            reqs.append((st, ("win", ws), st.local[lo : lo + ews]))
            ws += ews
        if full_end < cursor:
            lo = full_end - st.local_base
            if 0 <= lo and cursor - st.local_base <= len(st.local):
                reqs.append((st, ("tail", (full_end, cursor)),
                             st.local[lo : cursor - st.local_base]))
    if len(reqs) < 2:
        return 0.0
    t0 = _now_ms()
    stack, n_toks = _encode_batch(engine, [log_mel(s) for _, _, s in reqs])
    for i, (st, key, _) in enumerate(reqs):
        if n_toks[i] <= 0:
            continue
        if key[0] == "win":
            if st._pre_windows is None:
                st._pre_windows = {}
            st._pre_windows[key[1]] = (stack[i], n_toks[i])
        else:
            st._pre_tail = (key[1], stack[i], n_toks[i])
    engine._sync()
    ms = _now_ms() - t0
    engine.perf.encode_ms += ms
    return ms


def quantize_block(S: int, W: int, pcap: int):
    """Quantize a delta-prefill block [S, S+W) to the width ladder of the
    JAX package's prewarmed programs: pow2 widths from 64, or the full
    pcap.  Rounding W up and sliding S down recomputes kept rows only
    (identical by determinism -- the reuse contract).  Invariants (held by
    tests/test_torch_multistream.py): S' <= S, S' + W' <= pcap, W' >= W, S'
    stays 64-granular, W' is a pow2 or the full pcap.  The port applies it
    to every round, so both packages run the same blocks."""
    Wq = 64
    while Wq < W:
        Wq *= 2
    if Wq >= pcap:
        return 0, pcap
    return min(S, pcap - Wq), Wq


def _run_batched_chunks(engine, works, cache: _BatchKV, row_of) -> None:
    """One shared-clock round: every active session's delta prefill and
    bounded greedy decode as one batch in the NATURAL cache layout, then
    each session's tokens fed back into its StreamState.

    Layout per row b: prompt KV at logical positions [0, len_b) (kept rows
    never move between rounds), end-pad garbage [len_b, pcap) masked via
    prompt_max, the shared decode region at [pcap, kcap) rewritten each
    round.  Only the block [S, S+W) below the shallowest per-row reuse point
    is prefilled (S = min over active rows of reused_b, floored to 64) --
    rows with deeper reuse recompute kept rows into the same values, so
    exactness against solo holds by greedy determinism.

    Exact-token contract: the reconstruction at the end replays
    Engine.decode_greedy's loop semantics per row (first token from the
    prefill, EOS ends before the callback, n_generated counts every
    consumed token), so StreamState sees the inputs of a solo run.
    """
    cfg = engine.cfg
    dev = engine.device
    perf = engine.perf
    no_reuse = os.environ.get("SMOLVISION_MSTREAM_NO_REUSE", "") == "1"

    def i32(values):
        return torch.as_tensor(np.asarray(values, np.int32), device=dev)

    max_new = max(st.max_new for st, _ in works)
    B = cache.B
    max_len = max(len(w.ids) for _, w in works)
    pcap = max(cache.pcap, bucket128(max_len))
    kcap = pcap + max(BATCH_DECODE_CHUNK, bucket(max_new, 64))
    acap = bucket(max(w.enc_seq_len for _, w in works), 16)
    t_pre0 = _now_ms()

    # ---- per-row reuse --------------------------------------------------
    active = {row_of[id(st)]: (st, w) for st, w in works}
    lens_new = [0] * B
    reused_eff = [0] * B
    for r, (st, w) in active.items():
        n = len(w.ids)
        lens_new[r] = n
        if cache.valid[r] and not no_reuse:
            reused_eff[r] = max(0, min(w.reused, cache.lens[r], n - 1))

    if cache.kv is None:
        cache.kv = pbatch.make_batched_kv(cfg, B, kcap, engine.batched_kv_dtype, dev)
        cache.loop = None
        cache.caches += 1
    elif kcap > cache.kcap:
        cache.kv = pbatch.kv_grow_k(cache.kv, kcap)
        cache.loop = None
        cache.caches += 1
        cache.grows += 1

    # ---- the round's inputs (natural layout: no left pad) ---------------
    ids_arr = np.zeros((B, pcap), dtype=np.int64)
    astart = np.full((B,), -1_000_000, dtype=np.int32)
    alen = np.zeros((B,), dtype=np.int32)
    prompt_max = np.zeros((B,), dtype=np.int32)
    audio_rows: List[Optional[torch.Tensor]] = [None] * B
    a0 = None
    for r, (st, w) in active.items():
        ids_arr[r, : lens_new[r]] = np.asarray(w.ids, dtype=np.int64)
        astart[r] = w.audio_start
        alen[r] = w.enc_seq_len
        prompt_max[r] = lens_new[r]
        blk = w.audio_block[:acap]
        if blk.shape[0] < acap:
            blk = torch.cat([blk, blk.new_zeros((acap - blk.shape[0], blk.shape[1]))])
        audio_rows[r] = blk
        if a0 is None:
            a0 = r
    for r in range(B):
        # inactive rows duplicate an active row's inputs (independent rows;
        # outputs discarded; prompt_max 0 masks their cache rows) -- their
        # kept rows are clobbered by the shared block write, so invalidate
        if r not in active:
            ids_arr[r] = ids_arr[a0]
            astart[r] = astart[a0]
            alen[r] = alen[a0]
            audio_rows[r] = audio_rows[a0]
            cache.valid[r] = False

    # the batch-uniform delta block [S, S+W): down to the shallowest reuse
    # point among the active rows, floored to a multiple of 64, W bucketed
    S = (min(reused_eff[r] for r in active) // 64) * 64
    S, W = quantize_block(S, min(bucket(max_len - S, 64), pcap - S), pcap)
    # a torch slice past the end would shorten the block (the JAX package's
    # dynamic_slice clamps): the embeddings span pcap columns and the block
    # must fit inside them
    if not (0 <= S and S + W <= pcap and S + W >= max_len):
        raise ValueError(f"delta block [{S}, {S + W}) outside the prompt cap {pcap} "
                         f"or short of the longest prompt ({max_len})")
    embeds = dec_mod.build_embeds_batched(engine.dec_params, torch.from_numpy(ids_arr).to(dev),
                                          torch.stack(audio_rows), i32(astart), i32(alen))
    embeds_blk = embeds[:, S : S + W]
    last_rows = [max(0, lens_new[r] - 1 - S) if r in active else 0 for r in range(B)]
    first, cache.kv = dec_mod.batched_prefill_delta(
        engine.dec_params, cfg, embeds_blk, S, cache.kv, i32([S] * B), i32([0] * B),
        last_rows=i32(last_rows), prompt_max=i32(prompt_max), region_start=pcap)
    perf.delta_prefills += 1
    first_h = first.cpu().numpy()          # the prefill's end on the card
    B_real = len(works)
    prefill_ms = _now_ms() - t_pre0
    for r, (st, w) in active.items():
        w.reused = reused_eff[r]   # the reuse this round had, for the stats line
        st.note_prefill(w, len(w.ids), prefill_ms / B_real)

    # ---- bounded greedy decode in the shared region [pcap, kcap) ---------
    t_dec0 = _now_ms()
    rows = {r: [int(first_h[r])] for r in active}
    done = [r not in active or int(first_h[r]) in EOS_TOKEN_IDS for r in range(B)]
    inputs = {"rope_offset": np.asarray([pcap - lens_new[r] if r in active else pcap
                                         for r in range(B)], np.int32),   # rope = len_b + step
              "kv_min": np.zeros(B, np.int32), "prompt_max": prompt_max,
              "region_start": np.full(B, pcap, np.int32)}
    # pad rows decode promptless garbage that rarely hits EOS: keep them out
    # of the all-rows-EOS exit
    row_active = np.asarray([r in active for r in range(B)])
    tokens = first
    pos = pcap
    produced = 1
    replays_total = 0
    while produced < max_new and not all(done):
        if cache.loop is None:
            cache.loop = pbatch.batched_decode_loop(engine.dec_params, cfg, cache.kv, B, perf,
                                                    natural=True)
        steps = min(BATCH_DECODE_CHUNK, max_new - produced)
        buf, count, replays = cache.loop.run(tokens, pos, steps, row_active=row_active,
                                             **inputs)
        tokens = cache.loop.tok
        replays_total += replays
        if count == 0:
            break
        for r in active:
            if done[r]:
                continue
            for t in buf[r][:count]:
                t = int(t)
                rows[r].append(t)
                if t in EOS_TOKEN_IDS:
                    done[r] = True
                    break
        pos += count
        produced += count
    decode_ms = _now_ms() - t_dec0
    perf.batch_decode_steps += replays_total
    perf.batch_decode_ms += decode_ms

    # ---- persist the round's cache state --------------------------------
    cache.pcap = pcap
    cache.kcap = kcap
    for r in active:
        cache.lens[r] = lens_new[r]
        cache.valid[r] = True
    cache.rounds.append({"B": B, "active": B_real, "S": S, "W": W, "pcap": pcap, "kcap": kcap,
                         "prefill_ms": prefill_ms, "decode_ms": decode_ms,
                         "steps": replays_total,
                         "reused": [reused_eff[r] for r in sorted(active)],
                         "lens": [lens_new[r] for r in sorted(active)],
                         "prompt_max": prompt_max.tolist()})

    # replay decode_greedy's consumption semantics per session
    for r, (st, w) in active.items():
        chunk_tokens = []
        n = 0
        for t in rows[r]:
            if n >= st.max_new:
                break
            n += 1
            if t in EOS_TOKEN_IDS:
                break
            chunk_tokens.append(t)
        st.finish_chunk(w, chunk_tokens, n, decode_ms / B_real)
