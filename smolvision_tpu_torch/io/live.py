"""Live audio source: a producer thread reading stdin incrementally.

Port of smolvision_tpu/io/live.py, copied whole (host code).  Equivalent
of qwen_live_audio_t (qwen_asr_audio.c:396-607): reads stdin in ~2 s
(64,000-byte) chunks into a lock+condition-guarded growable buffer with a
global `sample_offset`; a WAV header (if present) is validated for
16 kHz mono 16-bit (no resampling in the live path); EOF wakes the consumer.
The device never blocks on stdin — the stream state mirrors this buffer.
"""

from __future__ import annotations

import struct
import sys
import threading
from typing import Optional

import numpy as np

from smolvision_tpu_torch.config import SAMPLE_RATE

CHUNK_BYTES = 64_000  # ~2 s of s16le mono @ 16 kHz


class LiveAudio:
    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.samples = np.zeros(0, dtype=np.float32)
        self.sample_offset = 0  # global index of samples[0]
        self.eof = False
        self._thread: Optional[threading.Thread] = None

    # -- consumer API (under self.lock) ---------------------------------

    def wait_for(self, want_global: int) -> bool:
        """Block until data through `want_global` exists or EOF. Returns eof."""
        with self.cond:
            while self.sample_offset + len(self.samples) < want_global and not self.eof:
                self.cond.wait()
            return self.eof

    def available_through(self):
        """(global end index of buffered data, eof) — non-blocking.  The
        multi-stream coordinator polls this to decide whether a live
        session can join the round's batch without stalling the others."""
        with self.lock:
            return self.sample_offset + len(self.samples), self.eof

    def snapshot_and_reset(self):
        """Return (offset, samples_copy, eof) and empty the producer buffer
        (the consumer mirrors it locally, bounding producer memory)."""
        with self.cond:
            off = self.sample_offset
            data = self.samples
            eof = self.eof
            self.sample_offset = off + len(data)
            self.samples = np.zeros(0, dtype=np.float32)
            return off, data, eof

    # -- producer --------------------------------------------------------

    def _append(self, new: np.ndarray):
        with self.cond:
            self.samples = np.concatenate([self.samples, new])
            self.cond.notify_all()

    def _set_eof(self):
        with self.cond:
            self.eof = True
            self.cond.notify_all()

    def _reader(self, stream):
        try:
            first = stream.read(12)
            pending = b""
            if first[:4] == b"RIFF" and first[8:12] == b"WAVE":
                # Walk chunks up to 'data'; validate 16 kHz mono s16.
                hdr = b""
                while True:
                    ch = stream.read(8)
                    if len(ch) < 8:
                        self._set_eof()
                        return
                    cid = ch[:4]
                    (sz,) = struct.unpack("<I", ch[4:8])
                    if cid == b"data":
                        break
                    body = stream.read(sz + (sz & 1))
                    if cid == b"fmt ":
                        fmt, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
                        if fmt != 1 or channels != 1 or rate != SAMPLE_RATE or bits != 16:
                            print("live audio: need 16 kHz mono s16 WAV on stdin",
                                  file=sys.stderr)
                            self._set_eof()
                            return
            else:
                pending = first

            while True:
                chunk = stream.read(CHUNK_BYTES - len(pending))
                data = pending + chunk
                pending = b""
                if not data:
                    break
                usable = len(data) // 2 * 2
                pending = data[usable:]
                if usable:
                    samples = np.frombuffer(data[:usable], dtype="<i2").astype(np.float32) / 32768.0
                    self._append(samples)
                if not chunk:
                    # EOF with a trailing odd byte: it can never complete a
                    # sample — looping on `data` (still 1 byte) would spin
                    # forever without ever signalling EOF
                    break
        finally:
            self._set_eof()

    @classmethod
    def start_stdin(cls) -> "LiveAudio":
        live = cls()
        live._thread = threading.Thread(
            target=live._reader, args=(sys.stdin.buffer,), daemon=True)
        live._thread.start()
        return live
