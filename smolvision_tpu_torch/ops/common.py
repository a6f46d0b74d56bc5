"""Core numeric ops shared by the models (torch; port of smolvision_tpu/ops/common.py).

Parity notes vs the reference kernels (qwen_asr_kernels.c):
  * GELU is the tanh approximation with 0.7978845608... (kernels.c:937-944),
    NOT erf GELU.
  * RMSNorm computes in f32 regardless of activation dtype (eps 1e-6 decoder).
  * LayerNorm has bias, eps 1e-5 (encoder).
  * RoPE is NeoX split-half: cos/sin of [angles, angles], rotate_half.
  * Sinusoidal PE: [sin || cos] halves with max_timescale 1e4.
Every matrix product goes through `linear`, which accumulates in f32 and
returns f32 like the JAX package's `preferred_element_type=f32` einsums.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from smolvision_tpu_torch.ops.quant import QuantW, proj


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; f32 math, returns weight * normalized (f32)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return weight.float() * (xf * torch.rsqrt(var + eps))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return normed * weight.float() + bias.float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU, matching qwen_asr_kernels.c:937-944."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sinusoidal_pe(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """[length, channels] = [sin(pos*inv_ts) || cos(pos*inv_ts)] (host const)."""
    half = channels // 2
    log_inc = np.log(max_timescale) / (half - 1)
    inv_timescales = np.exp(-log_inc * np.arange(half, dtype=np.float64))
    scaled = np.arange(length, dtype=np.float64)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables, each [*positions.shape, head_dim] (angles duplicated)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope_neox(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[..., None, :] + rotated * sin[..., None, :]


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., I] @ w[O, I]^T (+ b) -> f32 [..., O]; w may be a QuantW.

    x is first cast to w's dtype (the JAX callers' `.astype(wdt)`); the
    product accumulates in f32 and is returned in f32.  bf16 weights on the
    card use `torch.mm(..., out_dtype=float32)`, so the output is never
    rounded to bf16 (plain bf16 `matmul` would round it); the CPU build has
    no such kernel, so there bf16 operands are widened to f32 first (exact:
    every bf16 value and product is representable in f32).
    """
    if isinstance(w, QuantW):  # int8 weights (--q8): ops/quant.proj
        y = proj(x, w)
        return y if b is None else y + b
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
    if w.dtype == torch.float32:
        y = x2 @ w.t()
    elif x2.is_cuda:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float().t()
    y = y.reshape(*lead, w.shape[0])
    return y if b is None else y + b


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, M, K] @ b [N, K, P] -> f32 [N, M, P], `linear`'s rule for a
    batch of products (the MoE experts'): operands of one dtype, f32
    accumulation and output; bf16 on the card through
    `torch.bmm(..., out_dtype=float32)`, on the CPU widened first (exact)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b.float())
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())
