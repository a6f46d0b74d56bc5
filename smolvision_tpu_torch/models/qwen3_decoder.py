"""Dense Qwen3 LLM decoder in torch: prefill + decode step.

Port of the dense single-stream path of smolvision_tpu/models/qwen3_decoder.py
(reference semantics: qwen_asr_decoder.c, MODEL.md:156-227).

  * one KV cache [L, 2, Kcap, KH, D] (bf16, or f32 under --f32), updated in
    place: torch runs eagerly, so there is no donated functional update,
  * prefill writes the whole padded block's K/V rows into the cache (pad
    rows too, as the JAX package does) and then runs kernel B2, which masks
    every column >= start_pos + valid_len,
  * every decode step runs kernel B3 over the live rows [0, pos) plus
    the fresh row, then writes that row into the cache; there is no
    cache-size crossover (the JAX package's FLASH_DECODE_MIN_KCAP is a TPU
    measurement and does not apply here),
  * activations: residual stream f32, matmul inputs cast to the weight
    dtype, f32 accumulation (ops/common.linear).
"""

from __future__ import annotations

import torch

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.kernels import flash_attention as fa
from smolvision_tpu_torch.ops.common import apply_rope_neox, linear, rms_norm, rope_tables, silu


def make_kv_cache(cfg: ModelConfig, kv_cap: int, dtype=torch.bfloat16, device="cpu"):
    return torch.zeros((cfg.dec_layers, 2, kv_cap, cfg.dec_kv_heads, cfg.dec_head_dim),
                       dtype=dtype, device=device)


def build_embeds(params, ids: torch.Tensor, audio: torch.Tensor, audio_start: int,
                 audio_len: int) -> torch.Tensor:
    """Token embeddings with audio rows spliced in.

    ids: [Tcap] int (padded arbitrarily beyond the valid length); audio:
    [Acap, H] f32 encoder output.  Row i takes audio[i - audio_start] when
    audio_start <= i < audio_start + audio_len, else embed[ids[i]]
    (the replacement splice of MODEL.md:336-349).
    """
    emb = params["embed"][ids].float()
    rel = torch.arange(ids.shape[0], device=ids.device) - audio_start
    in_audio = (rel >= 0) & (rel < audio_len)
    audio_rows = audio[rel.clamp(0, audio.shape[0] - 1)].float()
    return torch.where(in_audio[:, None], audio_rows, emb)


def _split_gate_up(gate_up: torch.Tensor):
    """[..., 2I] -> (gate [..., I], up [..., I]) of the [gate; up] fusion."""
    I = gate_up.shape[-1] // 2
    return gate_up[..., :I], gate_up[..., I:]


def _attn_block(lp, h, kv, layer: int, cfg: ModelConfig, cos, sin, start_pos: int,
                valid_len: int):
    """One layer's attention half: input RMSNorm -> fused QKV -> per-head Q/K
    norm -> RoPE -> causal GQA attention vs the cache -> o-proj residual.
    Writes this block's K/V rows into kv[layer]."""
    T = h.shape[0]
    H, KH, D = cfg.dec_heads, cfg.dec_kv_heads, cfg.dec_head_dim
    eps = cfg.rms_norm_eps
    xn = rms_norm(h, lp["input_ln"], eps)
    qkv = linear(xn, lp["wqkv"])
    q = qkv[:, : H * D].reshape(T, H, D)
    k = qkv[:, H * D : (H + KH) * D].reshape(T, KH, D)
    v = qkv[:, (H + KH) * D :].reshape(T, KH, D)
    q = rms_norm(q, lp["q_norm"], eps)
    k = rms_norm(k, lp["k_norm"], eps)
    q = apply_rope_neox(q, cos, sin)
    k = apply_rope_neox(k, cos, sin)

    k_cache, v_cache = kv[layer, 0], kv[layer, 1]
    if T == 1:
        attn = fa.decode_flash_attention(q[0].contiguous(), k[0].contiguous(),
                                         v[0].contiguous(), k_cache, v_cache, start_pos)[None]
        k_cache[start_pos] = k[0].to(kv.dtype)
        v_cache[start_pos] = v[0].to(kv.dtype)
    else:
        k_cache[start_pos : start_pos + T] = k.to(kv.dtype)
        v_cache[start_pos : start_pos + T] = v.to(kv.dtype)
        attn = fa.causal_cache_flash_attention(q.contiguous(), k_cache, v_cache, start_pos,
                                               start_pos + valid_len)
    return h + linear(attn.reshape(T, H * D), lp["wo"])


def _dense_ffn(xn, lp):
    """Fused-SwiGLU dense FFN on [T, H] activations."""
    gate, up = _split_gate_up(linear(xn, lp["w_gate_up"]))
    return linear(silu(gate) * up, lp["w_down"])


def decoder_forward(params, cfg: ModelConfig, embeds: torch.Tensor, start_pos: int,
                    valid_len: int, kv: torch.Tensor):
    """Run the layer stack over `embeds` [T, H] written into cache rows
    start_pos..start_pos+T-1; T == 1 is a decode step (kernel B3), longer
    blocks are prefill (kernel B2).

    Returns (hidden [T, H] f32 pre-final-norm, kv) — kv is updated in place.
    Rows >= valid_len are junk; their cache rows are masked until overwritten.
    """
    T = embeds.shape[0]
    positions = start_pos + torch.arange(T, device=embeds.device)
    cos, sin = rope_tables(positions, cfg.dec_head_dim, cfg.rope_theta)
    layers = params["layers"]
    h = embeds.float()
    for i in range(layers["wqkv"].shape[0]):
        lp = {key: val[i] for key, val in layers.items()}
        h = _attn_block(lp, h, kv, i, cfg, cos, sin, start_pos, valid_len)
        h = h + _dense_ffn(rms_norm(h, lp["post_ln"], cfg.rms_norm_eps), lp)
    return h, kv


def logits_at(params, cfg: ModelConfig, hidden: torch.Tensor, row: int) -> torch.Tensor:
    """Final RMSNorm + lm_head logits [V] (f32) for one row of the hidden states."""
    h = rms_norm(hidden[row], params["final_norm"], cfg.rms_norm_eps)
    return linear(h[None], params["lm_head"])[0]


def prefill(params, cfg: ModelConfig, embeds, start_pos: int, valid_len: int, kv,
            greedy: bool = True):
    """Prefill the bucket; return (first token | logits of the last valid row, kv)."""
    hidden, kv = decoder_forward(params, cfg, embeds, start_pos, valid_len, kv)
    logits = logits_at(params, cfg, hidden, valid_len - 1)
    if greedy:
        return torch.argmax(logits).to(torch.int32), kv
    return logits, kv


def decode_step(params, cfg: ModelConfig, token, pos: int, kv, greedy: bool = True):
    """One autoregressive step writing cache row `pos`."""
    tok = torch.as_tensor(token, device=kv.device).reshape(1).long()
    embed = params["embed"][tok].float()
    hidden, kv = decoder_forward(params, cfg, embed, pos, 1, kv)
    logits = logits_at(params, cfg, hidden, 0)
    if greedy:
        return torch.argmax(logits).to(torch.int32), kv
    return logits, kv
