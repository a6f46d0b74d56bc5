"""Qwen2.5-Omni audio tower (Conv1D stem variant) in torch.

Port of smolvision_tpu/models/q25_encoder.py (reference semantics:
qwen25_omni_encoder.c:174-310).  Differences from the Qwen3 AuT
(models/qwen3_encoder.py):
  * Conv1D stem: k3 s1 p1 -> GELU -> k3 s2 p1 -> GELU (2x time downsample),
  * global sinusoidal PE (not per chunk; positions 0..T-1),
  * fixed 100-token attention windows (not mel-frame derived): kernel B1 at
    S 100,
  * the K projection has no bias (the loader substitutes zeros),
  * one `proj` d_model -> output_dim,
  * learned audio_bos / audio_eos rows around the output, which the engine
    adds (runtime/engine.py, `_encode_mel_q25`).

The transformer stack is the Qwen3 encoder's (`transformer_stack`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.models.qwen3_encoder import transformer_stack
from smolvision_tpu_torch.ops.common import gelu_tanh, layer_norm, linear, sinusoidal_pe


def q25_conv_stem(params, mel: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Conv1D stem + transpose + global sinusoidal PE.

    mel: [128, T] f32.  Returns [T2, d_model] f32 where T2 = (T + 1) // 2.
    """
    x = mel.float()[None]                                    # [1, 128, T] NCW
    x = F.conv1d(x, params["conv1_w"], stride=1, padding=1)
    x = gelu_tanh(x + params["conv1_b"][None, :, None])
    x = F.conv1d(x, params["conv2_w"], stride=2, padding=1)
    x = gelu_tanh(x + params["conv2_b"][None, :, None])
    x = x[0].t()                                             # [T2, d_model]
    pe = torch.from_numpy(sinusoidal_pe(x.shape[0], cfg.enc_d_model)).to(x.device)
    return x + pe


def q25_encoder_transformer(params, x: torch.Tensor, valid_len: int,
                            cfg: ModelConfig) -> torch.Tensor:
    """Windowed transformer (100-token windows) + ln_post + proj.

    x: [Tcap, d_model] f32, Tcap a multiple of cfg.q25_token_window.
    Returns [Tcap, output_dim] f32 (rows >= valid_len are garbage)."""
    h = transformer_stack(params["layers"], x, valid_len, cfg.q25_token_window,
                          cfg.enc_heads, cfg.enc_head_dim)
    h = layer_norm(h, params["ln_post_w"], params["ln_post_b"], eps=1e-5)
    return linear(h, params["proj_w"], params["proj_b"])


def q25_conv_out_len(mel_frames: int) -> int:
    """Token count after the conv stem: the s1 conv keeps T, the s2 conv
    halves it with the C arithmetic (qwen25_omni_encoder.c:190-198)."""
    l1 = (mel_frames + 2 - 3) // 1 + 1  # == mel_frames
    return (l1 + 2 - 3) // 2 + 1
