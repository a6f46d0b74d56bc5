"""WAV ingest: RIFF parsing, stereo downmix, windowed-sinc resampling.

Port of smolvision_tpu/io/wav.py.  Resampling goes through the host
runtime library (utils/native.py `sv_resample_sinc`); the numpy resampler
(`_resample_sinc_numpy`) stays as its plain version.

Parity notes (vs qwen_asr_audio.c:40-230):
  * 16-bit PCM, any sample rate / channel count; stereo is mean-downmixed
    before the /32768 scale.
  * Resampling to 16 kHz uses the same windowed-sinc interpolator: Kaiser
    window (beta=6), 16 zero-crossings per side, cutoff at the lower Nyquist,
    per-output coefficient-sum normalization.  The resampler affects which
    tokens the model emits, so the math matches the C code exactly (f64
    coefficients, truncated I0 power series with 20 terms).
  * stdin input auto-detects a WAV header vs raw s16le 16 kHz mono.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

from smolvision_tpu_torch.config import SAMPLE_RATE
from smolvision_tpu_torch.utils import native

_SINC_HALF = 16
_KAISER_BETA = 6.0


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel function of the first kind, order 0; 20-term power
    series (converges fast for beta <= 10), matching the reference."""
    x = np.asarray(x, dtype=np.float64)
    total = np.ones_like(x)
    term = np.ones_like(x)
    xx = x * x
    for k in range(1, 21):
        term = term * xx / (4.0 * k * k)
        total = total + term
    return total


def resample_sinc(samples: np.ndarray, in_rate: int, out_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Windowed-sinc resample (Kaiser beta=6, 16 zero-crossings/side), in the
    host runtime library."""
    if in_rate == out_rate:
        return np.asarray(samples, dtype=np.float32)
    return native.resample_sinc(samples, in_rate, out_rate)


def _resample_sinc_numpy(samples: np.ndarray, in_rate: int, out_rate: int = SAMPLE_RATE,
                         block: int = 1 << 16) -> np.ndarray:
    """The numpy resampler, `resample_sinc`'s plain version (f64
    coefficients, as the C code)."""
    if in_rate == out_rate:
        return np.asarray(samples, dtype=np.float32)

    samples = np.asarray(samples, dtype=np.float64)
    n = len(samples)
    new_n = int(n * out_rate // in_rate)
    ratio = float(out_rate) / float(in_rate)
    cutoff = min(ratio, 1.0)
    inv_i0_beta = 1.0 / float(_bessel_i0(np.float64(_KAISER_BETA)))
    offsets = np.arange(-_SINC_HALF + 1, _SINC_HALF + 1, dtype=np.int64)  # 32 taps

    out = np.empty(new_n, dtype=np.float32)
    for b0 in range(0, new_n, block):
        b1 = min(b0 + block, new_n)
        i = np.arange(b0, b1, dtype=np.float64)
        src_pos = i / ratio
        center = src_pos.astype(np.int64)
        j = center[:, None] + offsets[None, :]           # [B, 32]
        d = j.astype(np.float64) - src_pos[:, None]
        x = d * cutoff
        s = np.sinc(x)  # sin(pi x)/(pi x), sinc(0)=1 — same as the C branch
        npos = d / _SINC_HALF
        inside = np.abs(npos) < 1.0
        w = np.where(inside, _bessel_i0(_KAISER_BETA * np.sqrt(np.maximum(0.0, 1.0 - npos * npos))) * inv_i0_beta, 0.0)
        coeff = s * w * cutoff
        valid = (j >= 0) & (j < n)
        gathered = samples[np.clip(j, 0, n - 1)] * valid
        acc = np.sum(gathered * coeff, axis=1)
        wsum = np.sum(coeff, axis=1)
        out[b0:b1] = np.where(wsum > 1e-9, acc / np.where(wsum > 1e-9, wsum, 1.0), 0.0).astype(np.float32)
    return out


def parse_wav_buffer(data: bytes) -> np.ndarray:
    """Parse a WAV byte buffer -> float32 mono samples at 16 kHz.

    Chunk-walk semantics mirror qwen_asr_audio.c:40-69 exactly (pinned by
    the input-space fuzz, tools/fuzz_parity_c.py): every chunk is visited
    and the LAST fmt / data chunks win; a chunk whose declared size
    overruns the file ends the walk BEFORE being parsed (so an overrun
    data header means rejection, not clamping); odd chunk sizes are
    word-aligned; a fmt chunk shorter than 16 bytes is skipped.
    """
    if len(data) < 44 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a valid WAV file")

    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + chunk_size > len(data):
            break
        if chunk_id == b"fmt " and chunk_size >= 16:
            audio_format, channels, sample_rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", data, pos + 8
            )
            fmt = (audio_format, channels, sample_rate, bits)
        elif chunk_id == b"data":
            pcm = data[pos + 8 : pos + 8 + chunk_size]
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or pcm is None:
        raise ValueError("WAV missing fmt or data chunk")

    audio_format, channels, sample_rate, bits = fmt
    if channels < 1:
        raise ValueError("WAV with zero channels")
    if audio_format == 1 and bits == 16:
        raw = np.frombuffer(pcm[: len(pcm) // 2 * 2], dtype="<i2")
        if channels > 1:
            # channel mix matches the C loop bit-for-bit: int16 values
            # summed in f32 (exact: integer magnitudes < 2^24), f32 divide
            # by the channel count, then the exact /2^15 scale
            raw = raw[: len(raw) // channels * channels].reshape(-1, channels)
            sums = raw.astype(np.float32).sum(axis=1, dtype=np.float32)
            samples = (sums / np.float32(channels)) / np.float32(32768.0)
        else:
            samples = raw.astype(np.float32) / np.float32(32768.0)
    elif audio_format == 3 and bits == 32:  # IEEE float (convenience extension)
        raw = np.frombuffer(pcm[: len(pcm) // 4 * 4], dtype="<f4")
        if channels > 1:
            raw = raw[: len(raw) // channels * channels].reshape(-1, channels)
            samples = raw.sum(axis=1, dtype=np.float32) / np.float32(channels)
        else:
            samples = raw.astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {audio_format} / {bits}-bit")

    if sample_rate != SAMPLE_RATE:
        return resample_sinc(samples, sample_rate, SAMPLE_RATE)
    return samples


def load_wav(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return parse_wav_buffer(f.read())


def read_pcm_stdin() -> np.ndarray:
    """Read all of stdin; auto-detect WAV vs raw s16le 16 kHz mono.

    Autodetect mirrors qwen_read_pcm_stdin (qwen_asr_audio.c:206-218):
    under 4 bytes is an error, and the "RIFF" prefix ALONE routes to the
    WAV parser — RIFF-prefixed data with a bad body is a parse error, not
    a fallback to raw PCM (the reference never falls back)."""
    data = sys.stdin.buffer.read()
    if len(data) < 4:
        raise ValueError("no data on stdin")
    if data[0:4] == b"RIFF":
        return parse_wav_buffer(data)
    raw = np.frombuffer(data[: len(data) // 2 * 2], dtype="<i2")
    return (raw.astype(np.float32) / 32768.0)


def duration_sec(samples: np.ndarray) -> float:
    return len(samples) / float(SAMPLE_RATE)
