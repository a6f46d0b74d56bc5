"""The plain reference of Qwen3-ASR (its dense decoder): the log-mel front
end, the audio encoder, the prompt and the decoder's full causal forward,
in numpy and plain torch at float32 with TF32 off.

It follows the published architecture as the program serves it, written
out once more with no kernel, cache, bucket, batch or graph:
  * front end: reflect-padded 400-point periodic Hann frames at hop 160,
    the power spectrum (last frame dropped), a Slaney 128-bin filterbank,
    log10 clamped at 1e-10, the clip's max - 8 floor, (x + 4) / 4;
  * encoder: 100-frame chunks (a shorter last one at its own width)
    through three 3x3 stride-2 convolutions with tanh-GELU, the
    channel-major flatten, conv_out, a sinusoidal position per chunk
    (from 0 in each); attention within windows of 104 tokens
    (n_window_infer 800 frames), pre-LayerNorm (eps 1e-5) blocks with
    biases and a tanh-GELU FFN; ln_post, proj1 + GELU, proj2;
  * decoder: the chat prompt with the audio rows spliced over the pad
    tokens, RMSNorm (eps 1e-6), GQA with per-head q/k RMSNorm and NeoX
    RoPE (theta 1e6) at positions 0.., the SwiGLU FFN, the final norm and
    the tied head.

Weights come from the benchmark's seeded checkpoint (portbench/weights.py),
drawn here again from the seed, never from the program.  `quant="int8"`
puts each decoder matrix through symmetric per-row int8 (the control of
the correctness check: the precision below the bf16 the configuration
serves).

This module imports nothing of the program.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
HOP = 160
N_FFT = 400
N_MELS = 128
N_FREQ = N_FFT // 2 + 1

# special ids and the ASR chat prompt of the Qwen3-ASR family
AUDIO_PAD = 151676
PREFIX = [151644, 8948, 198, 151645, 198, 151644, 872, 198, 151669]
SUFFIX = [151670, 151645, 198, 151644, 77091, 198]

ENC = "thinker.audio_tower"
DEC = "thinker.model"


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) * 27.0
                    / np.log(6.4), 3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (np.maximum(m, 15.0) - 15.0)),
                    200.0 * m / 3.0)


@functools.lru_cache(maxsize=1)
def mel_filters() -> np.ndarray:
    """Slaney triangular filterbank [128, 201]."""
    fft_f = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FREQ)
    pts = _mel_to_hz(np.linspace(float(_hz_to_mel(0.0)), float(_hz_to_mel(SAMPLE_RATE / 2.0)),
                                 N_MELS + 2))
    diff = np.diff(pts)
    fb = np.zeros((N_MELS, N_FREQ))
    for m in range(N_MELS):
        down = (fft_f - pts[m]) / diff[m]
        up = (pts[m + 2] - fft_f) / diff[m + 1]
        fb[m] = np.maximum(0.0, np.minimum(down, up)) * 2.0 / (pts[m + 2] - pts[m])
    return fb


def n_frames(n_samples: int) -> int:
    return (n_samples + 2 * (N_FFT // 2) - N_FFT) // HOP


def log_mel(samples: np.ndarray) -> np.ndarray:
    """[128, frames] float64 log-mel of one clip."""
    x = np.asarray(samples, np.float64)
    n, pad = len(x), N_FFT // 2
    padded = np.zeros(n + 2 * pad)
    padded[pad:pad + n] = x
    # reflection without the edge sample; reflections past the clip are 0
    for i in range(pad):
        if pad - i < n:
            padded[i] = x[pad - i]
        if n - 2 - i >= 0:
            padded[pad + n + i] = x[n - 2 - i]
    frames = n_frames(n)
    idx = np.arange(frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    spec = np.fft.rfft(padded[idx] * window, axis=1)
    mel = (spec.real ** 2 + spec.imag ** 2) @ mel_filters().T
    ls = np.log10(np.maximum(mel, 1e-10))
    ls = np.maximum(ls, ls.max() - 8.0)
    return ((ls + 4.0) / 4.0).T


# ---------------------------------------------------------------------------
# host arithmetic: token counts and prompts
# ---------------------------------------------------------------------------

def _conv_w(w: int) -> int:
    return (w + 2 - 3) // 2 + 1


def chunk_tokens(frames: int) -> int:
    return _conv_w(_conv_w(_conv_w(frames)))


def audio_tokens(n_samples: int, chunk: int = 100) -> int:
    """Encoder tokens of a clip of n_samples."""
    f = n_frames(n_samples)
    return (f // chunk) * chunk_tokens(chunk) + (chunk_tokens(f % chunk) if f % chunk else 0)


def asr_prompt(n_audio: int) -> Tuple[List[int], int]:
    """(ids, audio_start) of the plain ASR prompt: no language, no context."""
    ids = PREFIX + [AUDIO_PAD] * n_audio + SUFFIX
    return ids, len(PREFIX)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _quant_rows(w: torch.Tensor) -> torch.Tensor:
    """w through symmetric per-row int8 over its last axis, back in f32."""
    s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(w / s), -127, 127) * s


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps))


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * w + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _sinusoid(length: int, channels: int, device) -> torch.Tensor:
    half = channels // 2
    inv = torch.exp(-math.log(10000.0) / (half - 1) * torch.arange(half, dtype=torch.float64))
    ang = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float().to(device)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX RoPE of x [T, heads, D] at positions 0..T-1."""
    T, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(torch.cat([ang, ang], -1)), torch.sin(torch.cat([ang, ang], -1))
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


class Case:
    """One greedy decode to judge: the prompt (ids, with n_audio rows from
    audio_start taken by `audio`, [n_audio, H] f32) and the tokens served
    after it."""

    def __init__(self, ids: Sequence[int], audio_start: int, audio: torch.Tensor,
                 served: Sequence[int], tag: str = ""):
        self.ids = list(ids)
        self.audio_start = audio_start
        self.audio = audio
        self.served = list(served)
        self.tag = tag


class Reference:
    """The model of configuration `cfg` (a config file's "model" group) over
    the weights `ckpt` (a SeededCheckpoint of the run's seed), in f32."""

    def __init__(self, cfg: dict, ckpt, device, quant: Optional[str] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.e, self.t = cfg["encoder"], cfg["text"]
        self.ckpt = ckpt
        self.device = torch.device(device)
        self.quant = quant
        self._enc: Optional[Dict[str, torch.Tensor]] = None

    def _w(self, name: str) -> torch.Tensor:
        return self.ckpt.get(name).to(self.device, torch.float32)

    def _dec_w(self, name: str) -> torch.Tensor:
        w = self._w(name)
        return _quant_rows(w) if self.quant == "int8" else w

    # -- encoder ----------------------------------------------------------

    def _enc_weights(self) -> Dict[str, torch.Tensor]:
        if self._enc is None:
            self._enc = {n[len(ENC) + 1:]: self._w(n) for n in self.ckpt.names()
                         if n.startswith(ENC + ".")}
        return self._enc

    def free_encoder(self) -> None:
        self._enc = None

    @torch.no_grad()
    def encode(self, samples: np.ndarray) -> torch.Tensor:
        """Audio samples -> encoder output [n_tokens, output_dim] f32."""
        w, e = self._enc_weights(), self.e
        d = e["d_model"]
        mel = torch.from_numpy(log_mel(samples)).float().to(self.device)
        chunk = 2 * e["n_window"]
        frames = mel.shape[1]
        parts = []
        for c0 in range(0, frames, chunk):
            x = mel[None, None, :, c0:c0 + chunk]
            for i in (1, 2, 3):
                x = _gelu(F.conv2d(x, w[f"conv2d{i}.weight"], w[f"conv2d{i}.bias"],
                                   stride=2, padding=1))
            _, C, Fq, w3 = x.shape
            x = x[0].permute(2, 0, 1).reshape(w3, C * Fq) @ w["conv_out.weight"].t()
            parts.append(x + _sinusoid(w3, d, self.device))
        h = torch.cat(parts)
        n = h.shape[0]
        win = chunk_tokens(chunk) * (e["n_window_infer"] // chunk)
        heads = e["encoder_attention_heads"]
        hd = d // heads
        for i in range(e["encoder_layers"]):
            p = f"layers.{i}."
            x = _ln(h, w[p + "self_attn_layer_norm.weight"], w[p + "self_attn_layer_norm.bias"])
            q, k, v = (x @ w[p + f"self_attn.{n_}_proj.weight"].t()
                       + w[p + f"self_attn.{n_}_proj.bias"] for n_ in "qkv")
            out = torch.empty_like(q)
            for s in range(0, n, win):
                sl = slice(s, min(s + win, n))
                qs, ks, vs = (t[sl].reshape(-1, heads, hd).transpose(0, 1) for t in (q, k, v))
                a = torch.softmax(qs @ ks.transpose(1, 2) / math.sqrt(hd), dim=-1) @ vs
                out[sl] = a.transpose(0, 1).reshape(-1, d)
            h = h + out @ w[p + "self_attn.out_proj.weight"].t() + w[p + "self_attn.out_proj.bias"]
            x = _ln(h, w[p + "final_layer_norm.weight"], w[p + "final_layer_norm.bias"])
            x = _gelu(x @ w[p + "fc1.weight"].t() + w[p + "fc1.bias"])
            h = h + x @ w[p + "fc2.weight"].t() + w[p + "fc2.bias"]
        h = _ln(h, w["ln_post.weight"], w["ln_post.bias"])
        h = _gelu(h @ w["proj1.weight"].t() + w["proj1.bias"])
        return h @ w["proj2.weight"].t() + w["proj2.bias"]

    # -- decoder ----------------------------------------------------------

    def _ffn(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = f"{DEC}.layers.{i}.mlp."
        g, u, dn = (self._dec_w(p + f"{n}_proj.weight") for n in ("gate", "up", "down"))
        return (F.silu(x @ g.t()) * (x @ u.t())) @ dn.t()

    @torch.no_grad()
    def logits(self, cases: Sequence[Case]) -> List[torch.Tensor]:
        """For each case, the logits [len(served), V] f32 that predict its
        served tokens: the full causal forward over the prompt and the
        served tokens but the last, layer by layer over all cases."""
        t = self.t
        H, heads, kvh, hd = (t["hidden_size"], t["num_attention_heads"],
                             t["num_key_value_heads"], t["head_dim"])
        eps, theta = t["rms_norm_eps"], t["rope_theta"]
        embed = self._dec_w(f"{DEC}.embed_tokens.weight")
        hs = []
        for c in cases:
            ids = torch.tensor(c.ids + c.served[:-1], dtype=torch.int64, device=self.device)
            h = embed[ids].clone()
            n = c.audio.shape[0]
            h[c.audio_start:c.audio_start + n] = c.audio.to(self.device, torch.float32)
            hs.append(h)
        del embed
        for i in range(t["num_hidden_layers"]):
            p = f"{DEC}.layers.{i}."
            ln1 = self._w(p + "input_layernorm.weight")
            ln2 = self._w(p + "post_attention_layernorm.weight")
            wq, wk, wv, wo = (self._dec_w(p + f"self_attn.{n}_proj.weight") for n in "qkvo")
            qn, kn = self._w(p + "self_attn.q_norm.weight"), self._w(p + "self_attn.k_norm.weight")
            for j, h in enumerate(hs):
                T = h.shape[0]
                x = _rms(h, ln1, eps)
                q = _rope(_rms((x @ wq.t()).reshape(T, heads, hd), qn, eps), theta)
                k = _rope(_rms((x @ wk.t()).reshape(T, kvh, hd), kn, eps), theta)
                v = (x @ wv.t()).reshape(T, kvh, hd)
                rep = heads // kvh
                k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
                s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
                mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
                a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
                h = h + torch.einsum("hts,shd->thd", a, v).reshape(T, heads * hd) @ wo.t()
                hs[j] = h + self._ffn(_rms(h, ln2, eps), i)
        norm = self._w(f"{DEC}.norm.weight")
        head = self._dec_w(f"{DEC}.embed_tokens.weight" if t.get("tie_word_embeddings", True)
                           else "thinker.lm_head.weight")
        out = []
        for c, h in zip(cases, hs):
            first = len(c.ids) - 1
            out.append(_rms(h[first:first + len(c.served)], norm, eps) @ head.t())
        return out


def served_gaps(logits: torch.Tensor, served: Sequence[int]) -> torch.Tensor:
    """Per served token: how far its logit lies below the best one."""
    idx = torch.tensor(list(served), dtype=torch.int64, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, idx[:, None])[:, 0]
