"""Streaming transcription: chunked prefix-rollback decoding with an
encoder window cache, degeneration recovery, and stable-frontier commits.

Port of smolvision_tpu/runtime/stream.py (the behaviour of stream_impl,
qwen_asr.c:1114-2219): one stream from a file (`--stream`) or live from
stdin (`--stdin --stream`), and the state machine each session of
multistream (runtime/multistream.py) steps:
  * 2 s chunks; first `unfixed_chunks` chunks decode with no text prefix;
    later chunks prepend raw decoded tokens minus the last `rollback`
    (official streaming policy, MODEL.md:402-432),
  * encoder window cache: completed n_window_infer-frame windows are
    immutable (hard attention boundaries) and encoded ONCE; only the partial
    tail is re-encoded each chunk; >4 windows are evicted (~32 s context).
    Cached windows are device tensors, joined per chunk with torch.cat,
  * prefill KV reuse: the longest-common-prefix of a host-side prompt
    SIGNATURE (token ids + audio-row identities) decides how many cached KV
    positions survive; the delta runs kernel B2 at start_pos = reused
    (`Engine.prefill_with_reuse`).  The cache is never reset between
    chunks, so the decode loop's CUDA graph (runtime/decode_graph.py) is
    captured once per cache and replayed by every chunk, and the delta's
    prefill graph once per (cache, block rows) and replayed by the chunks
    whose delta takes that bucket again,
  * bounded decode (stream_max_new_tokens, default 32),
  * repeat-run suppression (>12 identical tokens dropped),
  * degeneration recovery: repeated tail blocks (period<=6, reps>=4),
    4 stagnant chunks, or >=8 dropped repeats re-anchor the text state to the
    last 24 emitted tokens and clear all caches,
  * periodic reset every 45 chunks (conditioned mode),
  * stable-frontier commit: LCP against the previous candidate + 4..48-token
    overlap dedup against EMITTED tokens,
  * --monitor heartbeat symbols on stderr.

All constants preserved from qwen_asr.c:1369-1378.  The multistream
coordinator drives StreamState through three hooks: `nowait` live polling
(`begin_chunk` returns NOT_READY instead of blocking on a source whose next
chunk has not arrived), and the single-round pre-encoded windows and tail
(`_pre_windows`, `_pre_tail`) that its batched encode hands in.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from smolvision_tpu_torch.config import HOP_LENGTH, SAMPLE_RATE, TOKEN_ASR_TEXT
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.runtime import prompt as prompt_mod
from smolvision_tpu_torch.runtime.buckets import bucket
from smolvision_tpu_torch.runtime.segment import compact_silence

MAX_ENC_WINDOWS = 4
MAX_PREFIX_TOKENS = 150
MAX_REPEAT_TOKEN_RUN = 12
OVERLAP_MAX_TOKENS = 48
OVERLAP_MIN_TOKENS = 4
DEGEN_MAX_PERIOD = 6
DEGEN_MIN_REPEATS = 4
STALE_CHUNKS = 4
RESET_INTERVAL_CHUNKS = 45
RESET_CARRY_TOKENS = 24


def tail_repeat_blocks(tokens: List[int], max_period: int) -> Tuple[int, int]:
    """Max repetition count of a trailing block, and its period.

    (reps, period): e.g. [..., a,b,a,b,a,b] -> (3, 2).  Mirrors
    stream_tail_repeat_blocks (qwen_asr.c:1137-1163)."""
    n = len(tokens)
    if n < 2:
        return 1, 0
    best_reps, best_period = 1, 0
    period_cap = min(n // 2, max_period) if max_period > 0 else n // 2
    for p in range(1, period_cap + 1):
        reps = 1
        while (reps + 1) * p <= n:
            a = tokens[n - (reps + 1) * p : n - reps * p]
            b = tokens[n - reps * p : n - (reps - 1) * p]
            if a != b:
                break
            reps += 1
        if reps > best_reps:
            best_reps, best_period = reps, p
    return best_reps, best_period


class _EncWindowCache:
    """Completed encoder windows: device tensors + identity uids for the
    prefill-reuse signature."""

    def __init__(self):
        self.windows: List[Tuple[int, torch.Tensor, int, int]] = []  # (start, arr, seq, uid)
        self.next_uid = 0
        self.next_window_start = 0
        self.total_seq = 0

    def append(self, start: int, arr: torch.Tensor, seq: int):
        self.windows.append((start, arr, seq, self.next_uid))
        self.next_uid += 1
        self.total_seq += seq

    def evict_to(self, max_windows: int) -> int:
        evicted = 0
        while len(self.windows) > max_windows:
            _, _, seq, _ = self.windows.pop(0)
            self.total_seq -= seq
            evicted += 1
        return evicted

    def clear(self, new_start: int):
        self.windows.clear()
        self.total_seq = 0
        self.next_window_start = new_start


def _monitor(engine, sym: str):
    if engine.monitor:
        sys.stderr.write(sym)
        sys.stderr.flush()


def _encode_span(engine, samples: np.ndarray):
    """Encode one audio span -> (device tensor [Tcap, H], seq_len)."""
    if len(samples) <= 0:
        return None, 0
    return engine.encode_mel(log_mel(samples))


def transcribe_stream(engine, samples: np.ndarray) -> Optional[str]:
    return _stream_impl(engine, samples, None)


def transcribe_stream_live(engine, live) -> Optional[str]:
    return _stream_impl(engine, None, live)


# Sentinel returned by begin_chunk when a coordinated (nowait) live session
# does not yet have its next chunk's audio: NO state advanced -- the caller
# retries next round.  Distinct from None, which means the chunk was
# consumed-and-skipped (encoder starvation) and the state DID advance.
NOT_READY = object()


class ChunkWork:
    """Per-chunk work order produced by StreamState.begin_chunk: everything
    the prefill+decode middle needs, plus the bookkeeping finish_chunk
    consumes.  The middle is pluggable -- `run_solo_chunk` runs it through
    the engine's single-sequence KV-reuse path, the multistream coordinator
    through the batched decoder -- and must deliver the same greedy tokens
    either way."""

    __slots__ = ("ids", "audio_block", "audio_start", "enc_seq_len", "reused",
                 "n_prefix", "n_prefix_full", "is_final", "full_end", "t0")


class StreamState:
    """Step-able streaming session: the state machine of stream_impl
    (qwen_asr.c:1114-2219) with the model calls factored out.

    Protocol per chunk:
        work = state.begin_chunk()          # live ingest + encode + prompt
        if work is None: continue           # chunk skipped (encode starve)
        ... prefill (full or KV-delta) ...
        state.note_prefill(work, total_len, prefill_ms)
        ... bounded greedy decode ...
        state.finish_chunk(work, chunk_tokens, n_generated, decode_ms)
    until not state.active(); then state.finalize().

    All constants and ordering preserved from qwen_asr.c:1369-1378; the
    commit/recovery logic is held against the JAX package's
    (tests/test_torch_stream.py).
    """

    def __init__(self, engine, samples: Optional[np.ndarray], live):
        self.engine = engine
        cfg = engine.cfg
        self.cfg = cfg
        self.live = live
        self.chunk_samples = int(engine.stream_chunk_sec * SAMPLE_RATE)
        self.rollback = engine.stream_rollback
        self.unfixed_chunks = engine.stream_unfixed_chunks
        self.max_new = engine.stream_max_new_tokens or 32

        engine.perf.reset()
        engine.perf.decode_device = True    # finalize settles the decode loop's events
        engine.prepare_prompt()
        self.tok = engine.tokenizer
        self.forced = bool(engine._force_tokens)

        if live is None:
            # reported duration is the ORIGINAL clip length, even under
            # --skip-silence (qwen_asr.c:1345 uses the pre-compaction
            # n_samples; compaction at :1284-1289 only shrinks the work)
            engine.perf.audio_ms = 1000.0 * len(samples) / SAMPLE_RATE
        if live is None and engine.skip_silence:
            samples = compact_silence(samples)

        enc_window_frames = min(max(cfg.enc_n_window_infer, 100), 800)
        self.enc_window_samples = enc_window_frames * HOP_LENGTH

        no_cache_env = os.environ.get(
            "QWEN_STREAM_NO_ENC_CACHE",
            os.environ.get("SMOLVISION_STREAM_NO_ENC_CACHE", ""))
        self.use_enc_cache = not (no_cache_env and no_cache_env != "0")
        if live is not None and not self.use_enc_cache:
            self.use_enc_cache = True  # live requires the cache (bounded memory)

        if live is None:
            self.local = np.asarray(samples, dtype=np.float32)
            self.local_base = 0
            self.total_samples = len(self.local)
            self.live_eof = True
        else:
            off, data, self.live_eof = live.snapshot_and_reset()
            self.local = data
            self.local_base = off
            self.total_samples = self.local_base + len(self.local)

        self.t_session = time.monotonic() * 1000.0
        self.raw_tokens: List[int] = []
        self.stable_text: List[int] = []
        self.emitted: List[int] = []
        self.result_pieces: List[bytes] = []
        self.stagnant_chunks = 0
        self.chunk_idx = 0
        self.audio_cursor = 0
        self.enc_cache = _EncWindowCache()
        self.prev_signature: Optional[List] = None
        self.partial_uid = 1 << 40  # fresh ids for re-encoded partial tails
        self.prefill_total = 0
        self.prefill_reused = 0
        # multistream hooks: poll a live source instead of waiting, and the
        # round's pre-encoded windows {start: (arr, seq)} and tail
        # ((full_end, cursor), arr, seq), used once and cleared
        self.nowait = False
        self._pre_windows = None
        self._pre_tail = None

    # ------------------------------------------------------------------

    def active(self) -> bool:
        return (self.audio_cursor < self.total_samples
                or (self.live is not None and not self.live_eof))

    def _reanchor(self):
        """Re-anchor text state to a short committed tail (qwen_asr.c:1194-1248)."""
        carry = min(len(self.emitted), RESET_CARRY_TOKENS)
        tail = self.emitted[len(self.emitted) - carry :]
        self.raw_tokens = ([] if self.forced else [TOKEN_ASR_TEXT]) + list(tail)
        self.stable_text = list(tail)
        self.prev_signature = None

    def _ingest_live(self) -> bool:
        """Wait for the next chunk's audio (or EOF) and mirror the producer's
        buffer into the local one.  Under `nowait` it does not wait: False
        when the audio is not there yet (nothing changed)."""
        engine, live = self.engine, self.live
        want = self.audio_cursor + self.chunk_samples
        if self.nowait:
            end, eof = live.available_through()
            if end < want and not eof:
                return False
            self.live_eof = eof
        else:
            self.live_eof = live.wait_for(want)
        off, data, self.live_eof = live.snapshot_and_reset()
        local_end = self.local_base + len(self.local)
        if local_end < off:
            if engine.verbose >= 1:
                print(f"Streaming (live): local buffer overrun, resyncing "
                      f"(local_end={local_end}, live_start={off})",
                      file=sys.stderr, flush=True)
            self.local = data
            self.local_base = off
        elif len(data):
            skip = local_end - off
            if skip < len(data):
                self.local = np.concatenate([self.local, data[skip:]])
        self.total_samples = self.local_base + len(self.local)
        engine.perf.audio_ms = 1000.0 * self.total_samples / SAMPLE_RATE
        return True

    def begin_chunk(self) -> Optional[ChunkWork]:
        """Live ingest, cursor advance, encoder windows + partial tail,
        prompt build with prefix rollback, KV-reuse signature.  Returns None
        when the chunk is skipped (encoder starvation / empty audio) — the
        chunk index has already advanced in that case — and NOT_READY when
        a `nowait` live session's audio has not arrived (nothing advanced)."""
        with self.engine.perf.span("stream.begin", arg=self.chunk_idx):
            return self._begin_chunk()

    def _begin_chunk(self) -> Optional[ChunkWork]:
        engine = self.engine
        if self.live is not None and not self._ingest_live():
            return NOT_READY

        w = ChunkWork()
        w.t0 = time.monotonic() * 1000.0
        self.audio_cursor = min(self.audio_cursor + self.chunk_samples,
                                self.total_samples)
        w.is_final = ((self.live_eof if self.live is not None else True)
                      and self.audio_cursor >= self.total_samples)

        # ---- encoder: cached windows + partial tail -------------------
        # no synchronise: the prompt is built while the encoder runs; the
        # span's device ms goes into encode_ms when the call settles
        arg = self.chunk_idx
        with engine.perf.span("stream.encode", device=True, arg=arg) as span:
            ews = self.enc_window_samples
            w.full_end = (self.audio_cursor // ews) * ews
            segs = []       # list of (arr, seq, sig_tag)
            if not self.use_enc_cache:
                arr, seq = _encode_span(
                    engine, self.local[: self.audio_cursor - self.local_base])
                if seq <= 0:
                    self.chunk_idx += 1
                    return None
                self.partial_uid += 1
                segs = [(arr, seq, self.partial_uid)]
                enc_seq_len = seq
            else:
                pre_windows, pre_tail = self._pre_windows or {}, self._pre_tail
                # pre-encodes are single-round: cleared on every exit path
                self._pre_windows = self._pre_tail = None
                while self.enc_cache.next_window_start < w.full_end:
                    ws = self.enc_cache.next_window_start
                    lo = ws - self.local_base
                    if lo < 0 or lo + ews > len(self.local):
                        self.chunk_idx += 1
                        return None
                    pw = pre_windows.pop(ws, None)
                    arr, seq = (pw if pw is not None
                                else _encode_span(engine, self.local[lo : lo + ews]))
                    if seq <= 0:
                        self.chunk_idx += 1
                        return None
                    self.enc_cache.append(ws, arr, seq)
                    self.enc_cache.next_window_start += ews
                if self.enc_cache.evict_to(MAX_ENC_WINDOWS):
                    _monitor(engine, "⟳")

                partial_arr, partial_seq = (None, 0)
                if w.full_end < self.audio_cursor:
                    if pre_tail is not None and pre_tail[0] == (w.full_end, self.audio_cursor):
                        partial_arr, partial_seq = pre_tail[1], pre_tail[2]
                    else:
                        lo = w.full_end - self.local_base
                        partial_arr, partial_seq = _encode_span(
                            engine, self.local[lo : self.audio_cursor - self.local_base])

                segs = [(arr, seq, uid)
                        for (_, arr, seq, uid) in self.enc_cache.windows]
                if partial_seq > 0:
                    self.partial_uid += 1
                    segs.append((partial_arr, partial_seq, self.partial_uid))
                enc_seq_len = sum(s[1] for s in segs)
                if enc_seq_len <= 0:
                    self.chunk_idx += 1
                    return None
            span.into = "encode_ms"
        _monitor(engine, "▶")

        # assemble the audio embedding block on the device, padded to a
        # multiple of 16 rows
        parts = [arr[:seq] for (arr, seq, _) in segs]
        acap = bucket(enc_seq_len, 16)
        if acap > enc_seq_len:
            parts.append(parts[0].new_zeros((acap - enc_seq_len, parts[0].shape[1])))
        w.audio_block = parts[0] if len(parts) == 1 else torch.cat(parts)
        w.enc_seq_len = enc_seq_len

        # ---- prompt + prefix rollback ---------------------------------
        with engine.perf.span("stream.prompt", arg=arg):
            n_prefix_full = 0
            n_prefix = 0
            prefix_offset = 0
            if (engine.past_text_conditioning and self.chunk_idx >= self.unfixed_chunks
                    and self.raw_tokens):
                n_prefix_full = max(len(self.raw_tokens) - self.rollback, 0)
                n_prefix = n_prefix_full
                if n_prefix > MAX_PREFIX_TOKENS:
                    n_prefix = MAX_PREFIX_TOKENS
                    prefix_offset = n_prefix_full - n_prefix
            prefix_tokens = self.raw_tokens[prefix_offset : prefix_offset + n_prefix]
            w.n_prefix = n_prefix
            w.n_prefix_full = n_prefix_full

            w.ids, w.audio_start = prompt_mod.build_stream_prompt(
                self.cfg, enc_seq_len, engine._prompt_tokens, engine._force_tokens,
                prefix_tokens)

            # prompt signature for KV reuse (token ids + audio row identities)
            signature: List = [("t", t) for t in w.ids[: w.audio_start]]
            for (_, seq, uid) in segs:
                signature += [("a", uid, i) for i in range(seq)]
            signature += [("t", t) for t in w.ids[w.audio_start + enc_seq_len :]]

            reused = 0
            if self.prev_signature is not None:
                m = min(len(self.prev_signature), len(signature))
                while reused < m and self.prev_signature[reused] == signature[reused]:
                    reused += 1
            w.reused = reused
            self.prev_signature = signature
        return w

    def note_prefill(self, w: ChunkWork, total_len: int, prefill_ms: float):
        engine = self.engine
        self.prefill_total += total_len
        self.prefill_reused += min(w.reused, total_len - 1)
        engine.perf.decode_ms += prefill_ms
        engine.perf.prefill_ms += prefill_ms
        _monitor(engine, "·")
        if engine.verbose >= 2:
            print(f"  Prefill: {total_len} tokens ({w.n_prefix} prefix, "
                  f"reused {min(w.reused, total_len - 1)})",
                  file=sys.stderr, flush=True)

    def finish_chunk(self, w: ChunkWork, chunk_tokens: List[int],
                     n_generated: int, decode_ms: float):
        """History update, text parse, commit frontier, recovery / periodic
        resets, live buffer trim, perf accounting."""
        with self.engine.perf.span("stream.commit", arg=self.chunk_idx):
            self._finish_chunk(w, chunk_tokens, n_generated, decode_ms)

    def _finish_chunk(self, w: ChunkWork, chunk_tokens: List[int],
                      n_generated: int, decode_ms: float):
        engine = self.engine
        engine.perf.decode_ms += decode_ms
        # mirrors qwen_asr.c:2011 exactly: max-length detection looks only at
        # n_generated (a chunk whose max_new-th token is EOS still counts)
        hit_max = n_generated >= self.max_new
        _monitor(engine,
                 "▸" if (n_generated and decode_ms / n_generated > 30) else "▪")

        # ---- history update with repeat-run suppression ----------------
        n_prefix_full = w.n_prefix_full
        dropped_repeats = 0
        if chunk_tokens:
            prev_tok = (self.raw_tokens[n_prefix_full - 1]
                        if n_prefix_full > 0 else None)
            prev_run = 0
            if prev_tok is not None:
                prev_run = 1
                for j in range(n_prefix_full - 2, -1, -1):
                    if self.raw_tokens[j] != prev_tok:
                        break
                    prev_run += 1
                    if prev_run >= MAX_REPEAT_TOKEN_RUN:
                        break
            kept = []
            for t in chunk_tokens:
                if t == prev_tok:
                    prev_run += 1
                    if prev_run > MAX_REPEAT_TOKEN_RUN:
                        dropped_repeats += 1
                        continue
                else:
                    prev_tok = t
                    prev_run = 1
                kept.append(t)
            chunk_tokens = kept
        self.raw_tokens = self.raw_tokens[:n_prefix_full] + chunk_tokens

        # ---- text region parse -----------------------------------------
        text_start = 0
        if not self.forced:
            try:
                text_start = self.raw_tokens.index(TOKEN_ASR_TEXT) + 1
            except ValueError:
                text_start = 0
        candidate = self.raw_tokens[text_start:]
        n_text = len(candidate)

        # ---- commit frontier -------------------------------------------
        if w.is_final:
            candidate_len = n_text
        elif self.chunk_idx >= self.unfixed_chunks:
            candidate_len = n_text - self.rollback
            if candidate_len <= 0 and n_text > 0:
                candidate_len = n_text - 1
            candidate_len = max(candidate_len, 0)
        else:
            candidate_len = 0

        cand = candidate[:candidate_len]
        reps, period = tail_repeat_blocks(cand, DEGEN_MAX_PERIOD)
        advance = candidate_len - len(self.stable_text)
        if not w.is_final and hit_max and advance <= 1:
            self.stagnant_chunks += 1
        else:
            self.stagnant_chunks = 0

        recovery = (
            (period > 0 and reps >= DEGEN_MIN_REPEATS)
            or self.stagnant_chunks >= STALE_CHUNKS
            or dropped_repeats >= 8
        )
        if recovery:
            self._reanchor()
            self.enc_cache.clear(w.full_end)
            self.stagnant_chunks = 0
            _monitor(engine, "!")
            if engine.verbose >= 2:
                print("  Recovery reset applied", file=sys.stderr, flush=True)
        else:
            lcp = 0
            m = min(len(self.stable_text), candidate_len)
            while lcp < m and self.stable_text[lcp] == cand[lcp]:
                lcp += 1
            emit_start = lcp
            if emit_start < candidate_len and self.emitted:
                max_ov = min(candidate_len - emit_start, len(self.emitted),
                             OVERLAP_MAX_TOKENS)
                for k in range(max_ov, OVERLAP_MIN_TOKENS - 1, -1):
                    if (self.emitted[len(self.emitted) - k :]
                            == cand[emit_start : emit_start + k]):
                        emit_start += k
                        break
            for i in range(emit_start, candidate_len):
                t = cand[i]
                piece = self.tok.decode_piece(t)
                if engine.token_cb:
                    engine.token_cb(piece)
                self.result_pieces.append(piece)
                self.emitted.append(t)
                engine.perf.text_tokens += 1
                if engine.perf.stream_first_commit_ms is None:
                    engine.perf.stream_first_commit_ms = (
                        time.monotonic() * 1000.0 - self.t_session)
            self.stable_text = list(cand)

            periodic = (
                not w.is_final
                and engine.past_text_conditioning
                and self.chunk_idx >= self.unfixed_chunks
                and (self.chunk_idx + 1) % RESET_INTERVAL_CHUNKS == 0
            )
            if periodic:
                self._reanchor()
                self.enc_cache.clear(w.full_end)
                if engine.verbose >= 2:
                    print("  Periodic reset applied", file=sys.stderr, flush=True)

        # live mode: drop consumed samples before full_end
        if (self.live is not None and self.use_enc_cache
                and w.full_end > self.local_base):
            drop = min(w.full_end - self.local_base, len(self.local))
            if drop > 0:
                self.local = self.local[drop:]
                self.local_base += drop
                self.total_samples = self.local_base + len(self.local)

        chunk_wall = time.monotonic() * 1000.0 - w.t0
        engine.perf.total_ms += chunk_wall
        engine.perf.stream_chunk_ms.append(chunk_wall)
        self.chunk_idx += 1

    def finalize(self) -> str:
        engine = self.engine
        engine.perf.settle_mel()    # the chunks' device spans: encode_ms
        engine.perf.decode_device = False
        if engine.verbose >= 2 and self.prefill_total > 0:
            pct = 100.0 * self.prefill_reused / self.prefill_total
            print(f"  Prefill reuse: {self.prefill_reused}/{self.prefill_total} "
                  f"tokens ({pct:.1f}%)", file=sys.stderr, flush=True)
        lat = engine.perf.stream_latency()
        if engine.verbose >= 2 and lat is not None:
            first, p50, p99 = lat
            first_s = f"{first:.0f} ms" if first is not None else "n/a"
            print(f"  Stream latency: first commit {first_s}, "
                  f"chunk p50 {p50:.0f} ms / p99 {p99:.0f} ms "
                  f"({len(engine.perf.stream_chunk_ms)} chunks)",
                  file=sys.stderr, flush=True)
        return (b"".join(self.result_pieces)
                .decode("utf-8", errors="replace").strip())


def run_solo_chunk(state: StreamState, w: ChunkWork):
    """The prefill+decode middle of one chunk: the KV-reuse prefill (kernel
    B2 at start_pos = reused), then the greedy decode loop of at most
    max_new tokens on the same cache."""
    engine = state.engine
    perf = engine.perf
    arg = state.chunk_idx
    with perf.span("stream.chunk", arg=arg):
        with perf.span("stream.prefill", device=True, arg=arg) as span:
            first, total_len = engine.prefill_with_reuse(
                w.ids, w.audio_block, w.audio_start, w.enc_seq_len, w.reused)
            with perf.span("stream.wait_first", arg=arg):
                first = int(first)
        state.note_prefill(w, total_len, span.ms)

        chunk_tokens: List[int] = []
        with perf.span("stream.decode", arg=arg) as span:
            n_generated = engine.decode_greedy(
                first, total_len, state.max_new,
                lambda t: (chunk_tokens.append(t) or True))
        state.finish_chunk(w, chunk_tokens, n_generated, span.ms)


def _stream_impl(engine, samples: Optional[np.ndarray], live) -> Optional[str]:
    # --silent + preloaded file: one full-context refinement pass
    if engine.token_cb is None and live is None:
        engine.perf.reset()
        engine.prepare_prompt()
        # pre-compaction duration, as the reference reports (qwen_asr.c:1345)
        engine.perf.audio_ms = 1000.0 * len(samples) / SAMPLE_RATE
        if engine.skip_silence:
            samples = compact_silence(samples)
        text, _ = engine.transcribe_segment(samples)
        return text

    with engine.perf.span("stream.session"):
        state = StreamState(engine, samples, live)
        while state.active():
            w = state.begin_chunk()
            if w is None:
                continue
            run_solo_chunk(state, w)
        return state.finalize()
