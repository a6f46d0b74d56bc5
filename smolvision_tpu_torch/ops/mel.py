"""Log-mel spectrogram frontend (WhisperFeatureExtractor-compatible).

Pipeline (MODEL.md:53-64, qwen_asr_audio.c:236-394):
  reflect-pad(center) -> 400-pt periodic Hann frames, hop 160 -> power
  spectrum (drop last frame) -> Slaney 128-bin mel filterbank -> log10 clamp
  1e-10 -> dynamic-max minus 8.0 clamp -> (x+4)/4.  Output [128, frames].

Port of smolvision_tpu/ops/mel.py.  Three implementations:
  * `log_mel` -- host numpy (f64 rFFT).  The single-clip paths, every
    batch of one or two clips, f32 engines and `SMOLVISION_DEVICE_MEL=0`;
  * `log_mel_batch` -- torch on the input's device, over a batch of f16
    reflect-padded clips: the DFT as one product with the cos / sin tables
    (`dft_tables`), the power, the filterbank product, log10 and a per-clip
    max over its valid frames.  The front end of the batched paths on the
    card (runtime/batch_segments.py `_use_device_mel`);
  * `log_mel_torch` -- one clip's f32 padded audio through `torch.fft.rfft`
    (the JAX package's `log_mel_jax`).
The device versions run in full f32: `device.resolve_device` turns TF32
off, which would shift quiet bins by far more than the f16 audio does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from smolvision_tpu_torch.config import HOP_LENGTH, N_FFT, NUM_MEL_BINS, SAMPLE_RATE

N_FREQ = N_FFT // 2 + 1  # 201


def _hertz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )


def _mel_to_hertz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        min_log_hertz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freq,
    )


@functools.lru_cache(maxsize=1)
def mel_filters() -> np.ndarray:
    """Slaney-style triangular filterbank, shape [NUM_MEL_BINS, N_FREQ] f32."""
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FREQ)
    mel_min = float(_hertz_to_mel(0.0))
    mel_max = float(_hertz_to_mel(SAMPLE_RATE / 2.0))
    mel_pts = np.linspace(mel_min, mel_max, NUM_MEL_BINS + 2)
    filter_freqs = _mel_to_hertz(mel_pts)
    filter_diff = np.diff(filter_freqs)
    filter_diff = np.where(filter_diff == 0.0, 1e-6, filter_diff)

    fb = np.zeros((NUM_MEL_BINS, N_FREQ), dtype=np.float64)
    for m in range(NUM_MEL_BINS):
        down = (fft_freqs - filter_freqs[m]) / filter_diff[m]
        up = (filter_freqs[m + 2] - fft_freqs) / filter_diff[m + 1]
        fb[m] = np.maximum(0.0, np.minimum(down, up))
        fb[m] *= 2.0 / (filter_freqs[m + 2] - filter_freqs[m])
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=1)
def hann_window() -> np.ndarray:
    """Periodic Hann, 400 points."""
    i = np.arange(N_FFT, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / N_FFT))).astype(np.float32)


def reflect_pad(samples: np.ndarray, pad: int = N_FFT // 2) -> np.ndarray:
    """Center-mode reflect padding with the reference's short-signal edge
    semantics (out-of-range reflections become 0, qwen_asr_audio.c:300-312)."""
    n = len(samples)
    out = np.zeros(n + 2 * pad, dtype=np.float32)
    out[pad : pad + n] = samples
    left_src = pad - np.arange(pad)          # samples[pad-i] for i in [0,pad)
    left_ok = left_src < n
    out[:pad] = np.where(left_ok, samples[np.clip(left_src, 0, max(n - 1, 0))], 0.0) if n else 0.0
    right_src = n - 2 - np.arange(pad)
    right_ok = right_src >= 0
    out[pad + n :] = np.where(right_ok, samples[np.clip(right_src, 0, max(n - 1, 0))], 0.0) if n else 0.0
    return out


def num_frames(n_samples: int) -> int:
    """Frame count after center padding and dropping the last frame."""
    padded = n_samples + 2 * (N_FFT // 2)
    return (padded - N_FFT) // HOP_LENGTH + 1 - 1


def log_mel(samples: np.ndarray) -> np.ndarray:
    """Host numpy log-mel. samples: float32 [n] -> [128, frames] float32."""
    samples = np.asarray(samples, dtype=np.float32)
    padded = reflect_pad(samples)
    n_frames = num_frames(len(samples))
    if n_frames <= 0:
        raise ValueError(f"audio too short ({len(samples)} samples)")

    idx = np.arange(n_frames)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :]
    frames = padded[idx] * hann_window()[None, :]        # [frames, 400]
    spec = np.fft.rfft(frames.astype(np.float64), axis=1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)  # [frames, 201]
    mel = power @ mel_filters().T                         # [frames, 128]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return np.ascontiguousarray(log_spec.T)               # [128, frames]


@functools.lru_cache(maxsize=1)
def dft_tables():
    """cos / sin DFT tables [N_FFT, N_FREQ] f32: the power spectrum as
    products with precomputed tables (the reference's table DFT,
    qwen_asr_audio.c:328-358); f32 products match the host's f64 FFT to
    ~1e-6 in normalized-mel units."""
    k = np.arange(N_FREQ, dtype=np.float64)
    n = np.arange(N_FFT, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(n, k) / N_FFT
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _device_tables(device: torch.device):
    """The Hann window folded into the [cos | sin] table ([N_FFT, 2 *
    N_FREQ]) and the filterbank transposed ([N_FREQ, 128]), f32 on
    `device`."""
    C, S = dft_tables()
    cs = np.concatenate([C, S], axis=1) * hann_window()[:, None]
    return (torch.from_numpy(cs).to(device),
            torch.from_numpy(np.ascontiguousarray(mel_filters().T)).to(device))


def _finish(mel: torch.Tensor, n_frames_valid: torch.Tensor) -> torch.Tensor:
    """log10 clamp, the dynamic-max clamp per clip over its valid frames,
    (x + 4) / 4.  mel [B, cap, 128] -> [B, 128, cap]."""
    ls = torch.log10(torch.clamp(mel, min=1e-10))
    cap = mel.shape[1]
    valid = (torch.arange(cap, device=mel.device)[None, :]
             < n_frames_valid.to(mel.device)[:, None])[..., None]
    gmax = torch.where(valid, ls, float("-inf")).amax(dim=(1, 2), keepdim=True)
    ls = torch.maximum(ls, gmax - 8.0)
    return ((ls + 4.0) / 4.0).transpose(1, 2)


def log_mel_batch(padded_f16: torch.Tensor, n_frames_valid: torch.Tensor,
                  frames_cap: int) -> torch.Tensor:
    """Batched log-mel from f16 reflect-padded audio, on its device (the JAX
    package's `log_mel_batch_jax`).

    padded_f16: [B, frames_cap * HOP + N_FFT] float16, host reflect-padded
        and zero past each clip's data.
    n_frames_valid: [B] int, each clip's real frame count (the dynamic-max
        clamp is per clip over its valid frames only).
    Returns [B, 128, frames_cap] f32; columns >= n_frames_valid[b] hold
    finite garbage that the callers never select."""
    if padded_f16.shape[1] != frames_cap * HOP_LENGTH + N_FFT:
        raise ValueError(f"padded audio of {padded_f16.shape[1]} samples for a frame cap of "
                         f"{frames_cap}")
    cs, filt_t = _device_tables(padded_f16.device)
    B = padded_f16.shape[0]
    frames = padded_f16.float().unfold(1, N_FFT, HOP_LENGTH)[:, :frames_cap]  # [B, cap, 400]
    spec = torch.matmul(frames.reshape(B * frames_cap, N_FFT), cs)             # [B*cap, 402]
    power = spec[:, :N_FREQ].square() + spec[:, N_FREQ:].square()
    mel = torch.matmul(power, filt_t).reshape(B, frames_cap, NUM_MEL_BINS)
    return _finish(mel, n_frames_valid)


def log_mel_torch(padded_audio: torch.Tensor, n_frames_valid: int,
                  frames_cap: int) -> torch.Tensor:
    """One clip's log-mel over a fixed-size buffer through `torch.fft.rfft`
    (the JAX package's `log_mel_jax`).

    padded_audio: f32 [frames_cap * HOP + N_FFT], reflect-padded on the host
        and zero-padded to the cap.
    Returns [128, frames_cap]; columns >= n_frames_valid are garbage."""
    dev = padded_audio.device
    window = torch.from_numpy(hann_window()).to(dev)
    filt_t = torch.from_numpy(np.ascontiguousarray(mel_filters().T)).to(dev)
    frames = padded_audio.float().unfold(0, N_FFT, HOP_LENGTH)[:frames_cap] * window
    power = torch.fft.rfft(frames, dim=1).abs().square()                     # [cap, 201]
    mel = (power @ filt_t)[None]
    return _finish(mel, torch.tensor([n_frames_valid], device=dev))[0]
