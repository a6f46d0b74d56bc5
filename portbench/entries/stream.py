"""Live streaming: each call is one recording fed to
`runtime.stream.transcribe_stream_live` through the live-source protocol
(`wait_for`, `available_through`, `snapshot_and_reset`) from memory,
unpaced: a `wait_for` makes the audio it asks for available at once.

The chunk latency is measured from outside: the source stamps each
`wait_for` that advances the audio (the program taking a chunk), and the
call's return closes the last chunk.  For the check the harness keeps, per
chunk, the prompt the program built (its ids, where the audio rows sit and
the sample spans they encode) and the greedy tokens it decoded.  The
prompt's text prefix is the program's own earlier output (the stream's
rolled-back tokens), which the reference takes as given; the audio rows it
works out again from the spans."""

from __future__ import annotations

import threading
import time

import numpy as np

from portbench.reference import qwen3_asr as ref_mod


class MemorySource:
    """A live source over a recording held in memory."""

    def __init__(self, samples: np.ndarray, stamps: list):
        self.lock = threading.Lock()
        self.samples = samples
        self.released = 0          # samples made available
        self.taken = 0             # samples handed out by snapshot_and_reset
        self.stamps = stamps

    def _eof(self) -> bool:
        return self.released >= len(self.samples)

    def wait_for(self, want_global: int) -> bool:
        with self.lock:
            want = min(int(want_global), len(self.samples))
            if want > self.released:
                self.released = want
                self.stamps.append(time.perf_counter())
            return self._eof()

    def available_through(self):
        with self.lock:
            return self.released, self._eof()

    def snapshot_and_reset(self):
        with self.lock:
            off = self.taken
            data = self.samples[off:self.released].copy()
            self.taken = self.released
            return off, data, self._eof()


def prepare(run) -> None:
    from smolvision_tpu_torch.runtime import stream as stream_mod

    eng = run.engine
    eng.stream_chunk_sec = run.mix["chunk_sec"]
    eng.stream_max_new_tokens = run.mix["stream_max_new_tokens"]
    eng.past_text_conditioning = True      # the CLI's --stream default
    run.chunks = []
    run.tokens = []
    decode = eng.decode_greedy

    def recorded(first_token, start_pos, max_tokens, on_token):
        def seen(tid):
            run.tokens.append(int(tid))
            return on_token(tid)
        return decode(first_token, start_pos, max_tokens, seen)

    eng.decode_greedy = recorded
    # the program's own function, however many runs this process made
    solo = getattr(stream_mod.run_solo_chunk, "program_function", stream_mod.run_solo_chunk)

    def chunk(state, w):
        ews = state.enc_window_samples
        spans = [(start, start + ews) for (start, _, _, _) in state.enc_cache.windows]
        if w.full_end < state.audio_cursor:
            spans.append((w.full_end, state.audio_cursor))
        run.tokens = []
        solo(state, w)
        run.chunks.append({"ids": list(w.ids), "audio_start": w.audio_start,
                           "n_audio": w.enc_seq_len, "reused": w.reused, "spans": spans,
                           "tokens": list(run.tokens)})

    chunk.program_function = solo
    stream_mod.run_solo_chunk = chunk


def warmup(run) -> None:
    run.call(run.pool[0])


def call(run, req) -> dict:
    from smolvision_tpu_torch.runtime.stream import transcribe_stream_live

    stamps = []
    run.chunks = []
    transcribe_stream_live(run.engine, MemorySource(req.clips[0], stamps))
    stamps.append(time.perf_counter())
    run.totals.chunk_ms.extend(1000.0 * (b - a) for a, b in zip(stamps[:-1], stamps[1:]))
    return {"req": req.index, "clips": req.clips, "chunks": run.chunks,
            "answers": [len(run.chunks) > 0]}


def cases(run, records, ref, rng) -> list:
    """`check_chunks` chunks drawn from the window's streams, the one with
    the longest prompt among them."""
    pairs = [(k, j) for k, rec in enumerate(records) for j in range(len(rec["chunks"]))]
    size = lambda p: len(records[p[0]]["chunks"][p[1]]["ids"])  # noqa: E731
    longest = max(pairs, key=size)
    rest = [p for p in pairs if p != longest]
    n = min(run.mix["check_chunks"], len(pairs)) - 1
    chosen = [longest] + [rest[j] for j in rng.choice(len(rest), size=n, replace=False)]
    out = []
    for k, j in chosen:
        rec, ch = records[k], records[k]["chunks"][j]
        audio = ch_audio(ref, rec["clips"][0], ch["spans"])
        tag = f"stream {k} chunk {j}"
        if audio.shape[0] != ch["n_audio"]:
            out.append(ref_mod.Case([], 0, None, [], tag=tag + ": audio rows differ"))
            continue
        out.append(ref_mod.Case(ch["ids"], ch["audio_start"], audio, ch["tokens"], tag=tag))
    return out


def ch_audio(ref, samples, spans):
    import torch

    return torch.cat([ref.encode(samples[a:b]) for a, b in spans])


def work(run, rec) -> list:
    """Per chunk: the spans encoded anew (each window once, when it first
    appears, and the tail every chunk), the prefill past the reused rows,
    and the tokens decoded."""
    out, seen = [], set()
    for ch in rec["chunks"]:
        new = [b - a for (a, b) in ch["spans"][:-1] if (a, b) not in seen]
        seen.update(ch["spans"][:-1])
        if ch["spans"]:
            new.append(ch["spans"][-1][1] - ch["spans"][-1][0])
        total = len(ch["ids"])
        out.append({"samples": new, "prompt": total, "reused": min(ch["reused"], total - 1),
                    "generated": len(ch["tokens"])})
    return out
