"""Live input (--stdin --stream) in the port against the JAX package's.

The port's LiveAudio (io/live.py, a copy of the JAX package's) is fed the
same bytes as the JAX one through a fake stdin that hands them out in small
reads: WAV header checks, raw s16le, a trailing odd byte, incremental
consumption.  Then a whole live stream runs through both packages' engines
while the producer thread is still reading: it must reach EOF without
deadlock and give the JAX package's chunks and text.
"""

import io
import struct
import threading

import numpy as np
import pytest

from smolvision_tpu.io.live import LiveAudio as JLiveAudio
from smolvision_tpu.runtime import stream as jstream
from smolvision_tpu_torch.io.live import LiveAudio
from smolvision_tpu_torch.runtime import stream as tstream
from tests.test_torch_stream import _engines, build_stream_model, speech, stream_chunks


def _wav_header(n_samples, rate=16000, channels=1, bits=16):
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * 2 * channels, 2 * channels, bits)
    data_len = n_samples * 2
    return (b"RIFF" + struct.pack("<I", 36 + data_len) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", data_len))


class SlowStream(io.RawIOBase):
    """Hands out at most `step` bytes per read."""

    def __init__(self, data, step=8192):
        self.data = data
        self.pos = 0
        self.step = step

    def read(self, n=-1):
        if self.pos >= len(self.data):
            return b""
        n = min(n if n >= 0 else self.step, self.step, len(self.data) - self.pos)
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out


def _start(cls, data, step=8192):
    live = cls()
    t = threading.Thread(target=live._reader, args=(SlowStream(data, step),), daemon=True)
    t.start()
    return live, t


def _drain(cls, data, want, step=8192):
    """Wait for `want` samples (or EOF), join the reader, take everything."""
    live, t = _start(cls, data, step)
    live.wait_for(want)
    t.join(timeout=10)
    assert not t.is_alive()
    return live.snapshot_and_reset()


_S16 = (np.sin(np.arange(32000) / 20.0) * 0.4 * 32767).astype("<i2")
CASES = {
    "wav": (_wav_header(32000) + _S16.tobytes(), 32000, 32000),
    "raw_s16le": ((np.ones(16000) * 0.25 * 32767).astype("<i2").tobytes(), 16000, 16000),
    "wrong_rate": (_wav_header(100, rate=44100) + np.zeros(100, "<i2").tobytes(), 1, 0),
    "stereo": (_wav_header(100, channels=2) + np.zeros(200, "<i2").tobytes(), 1, 0),
    "odd_trailing_byte": ((np.ones(1000) * 0.25 * 32767).astype("<i2").tobytes() + b"\x7f",
                          1000, 1000),
    "truncated_header": (b"RIFF\x00\x00\x00\x00WAVEfmt ", 1, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_live_audio_matches_jax(name):
    data, want, n = CASES[name]
    off, got, eof = _drain(LiveAudio, data, want)
    joff, jgot, jeof = _drain(JLiveAudio, data, want)
    assert (off, eof, len(got)) == (joff, jeof, len(jgot)) == (0, True, n)
    np.testing.assert_array_equal(got, jgot)
    if name == "wav":
        np.testing.assert_allclose(got, _S16.astype(np.float32) / 32768.0, atol=1e-6)


def test_live_incremental_consumption():
    """The consumer mirrors and resets; the producer keeps appending."""
    samples = (np.arange(48000) % 100).astype("<i2")
    live, t = _start(LiveAudio, samples.tobytes(), step=16000)
    total, base = [], 0
    while True:
        live.wait_for(base + 8000)
        off, got, eof = live.snapshot_and_reset()
        assert off == base
        total.extend(got.tolist())
        base = off + len(got)
        assert live.available_through()[0] >= base   # the producer may run ahead
        if eof and base >= 48000:
            break
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.asarray(total), samples.astype(np.float32) / 32768.0)


@pytest.fixture(scope="module")
def live_engines(tmp_path_factory):
    model = build_stream_model(str(tmp_path_factory.mktemp("models") / "tiny-untied"))
    return _engines(model, enc_window_sec=1.0, max_new=6)


def test_live_stream_matches_jax(live_engines):
    """5 s of audio fed 1 s per read while the stream runs, 1 s windows (so
    the live buffer drops consumed samples): the port reaches EOF and gives
    the JAX package's chunks and text."""
    audio = speech(5.0, seed=5)
    data = _wav_header(len(audio)) + (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    out = []
    for cls, mod, eng in ((JLiveAudio, jstream, live_engines[0]),
                          (LiveAudio, tstream, live_engines[1])):
        live, thread = _start(cls, data, step=32000)
        out.append(stream_chunks(mod, eng, live=live))
        thread.join(timeout=10)
        assert not thread.is_alive()
    assert out[1] == out[0]
    chunks, text = out[1]
    assert len(chunks) >= 3 and text
