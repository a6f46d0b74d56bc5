"""Qwen3-ASR audio encoder (AuT) in torch (port of smolvision_tpu/models/qwen3_encoder.py).

Reference semantics: qwen_asr_encoder.c:171-372, MODEL.md:85-152.

  * the Conv2D stem runs batched over chunks: all full 100-frame chunks are
    one [B, 1, 128, 100] conv; the final partial chunk (if any) is a separate
    call at its true width (zero-padding would corrupt edge outputs because
    GELU(conv(0)+bias) != 0 in layer 2+),
  * per-chunk sinusoidal PEs (restarting at 0 each chunk) are added right
    after the conv_out projection,
  * windowed bidirectional attention reshapes the padded token sequence to
    [n_windows, window_tokens, heads, head_dim]; the hard windows make the
    block-diagonal mask a reshape, and kernel B1 masks the pad keys of the
    last windows (kernels/flash_attention.window_flash_attention).  A batch
    of clips [B, Tcap, d] is B * n_windows windows in one B1 launch per
    layer, never one launch per clip.

Callers bucket `x` to a multiple of the window token size and pass
`valid_len`; rows >= valid_len are garbage and sliced off.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from smolvision_tpu_torch.config import ModelConfig, conv_out_width
from smolvision_tpu_torch.kernels import flash_attention as fa
from smolvision_tpu_torch.ops.common import gelu_tanh, layer_norm, linear, sinusoidal_pe


def conv_stem(params, mel_chunks: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Conv2D stem + conv_out projection + per-chunk sinusoidal PE.

    mel_chunks: [B, 128, w] (each row one chunk of <= 100 mel frames, all of
    width w).  Returns [B, w3, d_model] f32.
    """
    x = mel_chunks.float()[:, None, :, :]  # [B, 1, 128, w]
    for i in (1, 2, 3):
        x = F.conv2d(x, params[f"conv{i}_w"], stride=2, padding=1)
        x = gelu_tanh(x + params[f"conv{i}_b"][None, :, None, None])
    # [B, 480, 16, w3] -> [B, w3, 480*16] (channel-major flatten,
    # qwen_asr_encoder.c:262-271)
    B, C, Fq, w3 = x.shape
    x = x.permute(0, 3, 1, 2).reshape(B, w3, C * Fq)
    x = linear(x, params["conv_out_w"])
    pe = torch.from_numpy(sinusoidal_pe(w3, cfg.enc_d_model)).to(x.device)
    return x + pe[None, :, :]


def window_lens(valid_lens: Sequence[int], n_windows: int, window_tokens: int) -> List[int]:
    """Valid keys of each window when clip b holds windows [b * n_windows,
    (b + 1) * n_windows) and its first valid_lens[b] tokens are real."""
    S = window_tokens
    return [min(max(n - w * S, 0), S) for n in valid_lens for w in range(n_windows)]


def transformer_stack(layers, x: torch.Tensor, valid_len, window_tokens: int,
                      n_heads: int, head_dim: int) -> torch.Tensor:
    """Windowed-attention transformer stack.

    x: [Tcap, d_model] f32 with Tcap % window_tokens == 0, valid_len an int;
    or [B, Tcap, d_model] with one valid length per clip.  Every window of
    every clip goes through one kernel-B1 launch per layer.  layers: stacked
    [L, ...] tensors.  Returns x's shape, pre-ln_post states (f32).
    """
    shape = x.shape
    Tcap, d = shape[-2:]
    assert Tcap % window_tokens == 0, (Tcap, window_tokens)
    lens = [valid_len] if x.dim() == 2 else list(valid_len)
    W = Tcap // window_tokens
    S, H, D = window_tokens, n_heads, head_dim
    wl = torch.tensor(window_lens(lens, W, S), dtype=torch.int32, device=x.device)
    n = len(lens) * W
    h = x.float().reshape(n * S, d)
    for i in range(layers["wq"].shape[0]):
        lp = {key: val[i] for key, val in layers.items()}
        xn = layer_norm(h, lp["attn_ln_w"], lp["attn_ln_b"], eps=1e-5)
        q = linear(xn, lp["wq"], lp["bq"]).reshape(n, S, H, D)
        k = linear(xn, lp["wk"], lp["bk"]).reshape(n, S, H, D)
        v = linear(xn, lp["wv"], lp["bv"]).reshape(n, S, H, D)
        attn = fa.window_flash_attention(q, k, v, wl).reshape(n * S, H * D)
        h = h + linear(attn, lp["wo"], lp["bo"])
        xn = layer_norm(h, lp["ffn_ln_w"], lp["ffn_ln_b"], eps=1e-5)
        mid = gelu_tanh(linear(xn, lp["fc1"], lp["fc1_b"]))
        h = h + linear(mid, lp["fc2"], lp["fc2_b"])
    return h.reshape(shape)


def encoder_transformer(params, x: torch.Tensor, valid_len, cfg: ModelConfig,
                        window_tokens: int) -> torch.Tensor:
    """Transformer stack + ln_post + proj1/proj2.

    x: [Tcap, d_model] f32 with Tcap % window_tokens == 0 and an int
    valid_len, or a batch of clips [B, Tcap, d_model] with their valid
    lengths (the JAX package vmaps this function over clips).  Returns
    [(B,) Tcap, enc_output_dim] f32 (rows >= a clip's valid length are
    garbage).
    """
    h = transformer_stack(params["layers"], x, valid_len, window_tokens,
                          cfg.enc_heads, cfg.enc_head_dim)
    h = layer_norm(h, params["ln_post_w"], params["ln_post_b"], eps=1e-5)
    h = gelu_tanh(linear(h, params["proj1_w"], params["proj1_b"]))
    return linear(h, params["proj2_w"], params["proj2_b"])


def partial_chunk_tokens(w: int) -> int:
    """Encoder tokens from a partial chunk of w mel frames (C arithmetic)."""
    return conv_out_width(conv_out_width(conv_out_width(w)))


def total_encoder_tokens(mel_frames: int, cfg: ModelConfig) -> int:
    """Total encoder tokens for a mel of given length (qwen_asr_encoder.c:201-213)."""
    chunk = cfg.enc_chunk_size
    n_full = mel_frames // chunk
    rem = mel_frames % chunk
    total = n_full * cfg.tokens_per_chunk
    if rem:
        total += partial_chunk_tokens(rem)
    return total
