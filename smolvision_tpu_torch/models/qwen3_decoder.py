"""Dense Qwen3 LLM decoder in torch: prefill + decode step, single and batched.

Port of the dense paths of smolvision_tpu/models/qwen3_decoder.py
(reference semantics: qwen_asr_decoder.c, MODEL.md:156-227).

  * one KV cache [L, 2, Kcap, KH, D] (bf16, or f32 under --f32), updated in
    place: torch runs eagerly, so there is no donated functional update,
  * prefill writes the whole padded block's K/V rows into the cache (pad
    rows too, as the JAX package does) and then runs kernel B2, which masks
    every column >= start_pos + valid_len,
  * every decode step writes its row and runs kernel B3 over the live rows
    [0, pos) plus the fresh row; there is no cache-size crossover (the JAX
    package's FLASH_DECODE_MIN_KCAP is a TPU measurement and does not apply
    here),
  * a block's start may be a device tensor (the decode step's position, a
    prefill graph's start, the --spec verify's): B2 and B3 read it from
    device memory and the rows are written with index_copy_, so one CUDA
    graph replays at every start (runtime/decode_graph.py),
  * the batched decoder (segments, serving) keeps a [L, 2, B, KH, K, D]
    cache: fresh prefill runs kernel B4, delta prefill of a block of T > 1
    rows kernel B5, at every size (the JAX package's BATCHED_FLASH_MIN_T /
    BATCHED_DELTA_FLASH_MIN_T are TPU crossovers and do not apply here); a
    batched decode step is plain torch, as in the JAX package, at a device
    position: the whole cache under a mask (`batched_decode_step`),
  * activations: residual stream f32, matmul inputs cast to the weight
    dtype, f32 accumulation (ops/common.linear); int8 weights (--q8,
    ops/quant.QuantW) go through ops/quant.proj and embed_rows,
  * every greedy token comes from `greedy_head`: final RMSNorm, then kernel
    K6 (bf16 / f32 lm_head) or K7 (int8 lm_head), the fused lm_head matvec +
    argmax, which never writes the logits; the logits paths (greedy=False)
    keep `linear`,
  * the batched cache may be int8 (--kv8, ops/quant.QuantKV): fresh K/V
    rows are quantized per row as they are written; fresh prefill still
    runs B4 (it never reads the cache), while delta prefill and the decode
    step run the two-part attention on the cache rows widened to f32 with
    their scales, as the JAX package does (it sends the --kv8 delta prefill
    away from B5 as well).
    The single-stream cache stays bf16 / f32.
"""

from __future__ import annotations

import torch

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.device import resolve_device
from smolvision_tpu_torch.kernels import argmax_matvec as am
from smolvision_tpu_torch.kernels import flash_attention as fa
from smolvision_tpu_torch.ops.common import apply_rope_neox, linear, rms_norm, rope_tables, silu
from smolvision_tpu_torch.ops.quant import (QuantKV, QuantW, embed_rows, kv_read, kv_write,
                                            kv_zeros, take)


def make_kv_cache(cfg: ModelConfig, kv_cap: int, dtype=torch.bfloat16, device=None):
    """Single-stream KV cache [L, 2, K, KH, D] on `device` (the card unless
    the caller names the CPU)."""
    return torch.zeros((cfg.dec_layers, 2, kv_cap, cfg.dec_kv_heads, cfg.dec_head_dim),
                       dtype=dtype, device=resolve_device(device))


def build_embeds(params, ids: torch.Tensor, audio: torch.Tensor, audio_start: int,
                 audio_len: int) -> torch.Tensor:
    """Token embeddings with audio rows spliced in.

    ids: [Tcap] int (padded arbitrarily beyond the valid length); audio:
    [Acap, H] f32 encoder output.  Row i takes audio[i - audio_start] when
    audio_start <= i < audio_start + audio_len, else embed[ids[i]]
    (the replacement splice of MODEL.md:336-349).
    """
    emb = embed_rows(params["embed"], ids)
    rel = torch.arange(ids.shape[0], device=ids.device) - audio_start
    in_audio = (rel >= 0) & (rel < audio_len)
    audio_rows = audio[rel.clamp(0, audio.shape[0] - 1)].float()
    return torch.where(in_audio[:, None], audio_rows, emb)


def _split_gate_up(gate_up: torch.Tensor):
    """[..., 2I] -> (gate [..., I], up [..., I]) of the [gate; up] fusion."""
    I = gate_up.shape[-1] // 2
    return gate_up[..., :I], gate_up[..., I:]


def _attn_block(lp, h, kv, layer: int, cfg: ModelConfig, cos, sin, rows, start_pos, kv_valid):
    """One layer's attention half: input RMSNorm -> fused QKV -> per-head Q/K
    norm -> RoPE -> causal GQA attention vs the cache -> o-proj residual.
    Writes this block's K/V rows into kv[layer] at `rows` (int64 [T], by
    index_copy_).  A decode step (T == 1, kernel B3) has start_pos as its
    int32 device copy [1]; a longer block (kernel B2) has start_pos and
    kv_valid as host ints or device tensors."""
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
    k_cache.index_copy_(0, rows, k.to(kv.dtype))   # B3 reads only the rows before them
    v_cache.index_copy_(0, rows, v.to(kv.dtype))
    if T == 1:
        attn = fa.decode_flash_attention(q[0].contiguous(), k[0].contiguous(),
                                         v[0].contiguous(), k_cache, v_cache, start_pos)[None]
    else:
        attn = fa.causal_cache_flash_attention(q.contiguous(), k_cache, v_cache, start_pos,
                                               kv_valid)
    return h + linear(attn.reshape(T, H * D), lp["wo"])


def _dense_ffn(xn, lp):
    """Fused-SwiGLU dense FFN on [T, H] activations."""
    gate, up = _split_gate_up(linear(xn, lp["w_gate_up"]))
    return linear(silu(gate) * up, lp["w_down"])


def decoder_forward(params, cfg: ModelConfig, embeds: torch.Tensor, start_pos,
                    valid_len, kv: torch.Tensor):
    """Run the layer stack over `embeds` [T, H] written into cache rows
    start_pos..start_pos+T-1; T == 1 is a decode step (kernel B3), longer
    blocks are prefill (kernel B2).  start_pos is a host int or an int64
    device tensor [1] (the decode loop's position, a prefill graph's start,
    the --spec verify's), and valid_len a host int or such a tensor: a
    device start takes its RoPE angles, cache rows and B2's kv_valid =
    start + valid on the device, so one CUDA graph replays at every start
    (its owner checks the rows against the cache).  A decode step's host
    int is moved to the device.

    Returns (hidden [T, H] f32 pre-final-norm, kv) — kv is updated in place.
    Rows >= valid_len are junk; their cache rows are masked until overwritten.
    """
    if isinstance(kv, QuantKV):
        raise ValueError("the int8 KV cache (--kv8) is batched-path only (make_batched_kv)")
    T = embeds.shape[0]
    if T == 1 and not isinstance(start_pos, torch.Tensor):
        start_pos = torch.full((1,), start_pos, dtype=torch.int64, device=embeds.device)
    if isinstance(start_pos, torch.Tensor):
        start_pos = start_pos.reshape(1)
    elif start_pos < 0 or start_pos + T > kv.shape[2]:
        raise ValueError(f"cache rows {start_pos}..{start_pos + T} past its {kv.shape[2]}")
    rows = start_pos + torch.arange(T, device=embeds.device)
    cos, sin = rope_tables(rows, cfg.dec_head_dim, cfg.rope_theta)
    kv_valid = start_pos + valid_len if T > 1 else None
    if isinstance(start_pos, torch.Tensor):   # B2 / B3 read int32s from device memory
        start_pos = start_pos.to(torch.int32)
        kv_valid = None if kv_valid is None else kv_valid.to(torch.int32)
    layers = params["layers"]
    h = embeds.float()
    for i in range(layers["wqkv"].shape[0]):
        lp = {key: take(val, i) for key, val in layers.items()}
        h = _attn_block(lp, h, kv, i, cfg, cos, sin, rows, start_pos, kv_valid)
        h = h + _dense_ffn(rms_norm(h, lp["post_ln"], cfg.rms_norm_eps), lp)
    return h, kv


def logits_at(params, cfg: ModelConfig, hidden: torch.Tensor, row: int) -> torch.Tensor:
    """Final RMSNorm + lm_head logits [V] (f32) for one row of the hidden states."""
    h = rms_norm(hidden[row], params["final_norm"], cfg.rms_norm_eps)
    return linear(h[None], params["lm_head"])[0]


def greedy_head(params, cfg: ModelConfig, hidden_rows: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row of hidden_rows [R, H]: int32 [R].

    Final RMSNorm, then the fused lm_head matvec + argmax (kernel K6 for a
    bf16 / f32 lm_head, K7 for an int8 one): argmax(linear(...)) without the
    logits.  An int8 head computes the dequantized product bf16(h) .
    bf16(q) * s, the JAX package's `proj` below 1024 rows (a batch of 1024
    rows or more would take its int8 x int8 branch instead)."""
    h = rms_norm(hidden_rows, params["final_norm"], cfg.rms_norm_eps).contiguous()
    w = params["lm_head"]
    if isinstance(w, QuantW):
        return am.argmax_matvec(h, w.q, w.s)
    return am.argmax_matvec(h, w)


def last_row(hidden: torch.Tensor, valid_len) -> torch.Tensor:
    """Row valid_len - 1 of hidden [T, H] as [1, H], by index_select: valid_len
    a host int or a device tensor (a prefill graph's), never read back."""
    if not isinstance(valid_len, torch.Tensor):
        return hidden[valid_len - 1 : valid_len]
    return hidden.index_select(0, (valid_len.reshape(1) - 1).long())


def prefill(params, cfg: ModelConfig, embeds, start_pos, valid_len, kv, greedy: bool = True):
    """Prefill the bucket; return (first token | logits of the last valid row, kv).
    start_pos / valid_len are host ints or (greedy only) device tensors."""
    hidden, kv = decoder_forward(params, cfg, embeds, start_pos, valid_len, kv)
    if greedy:
        return greedy_head(params, cfg, last_row(hidden, valid_len))[0], kv
    return logits_at(params, cfg, hidden, valid_len - 1), kv


def decode_step(params, cfg: ModelConfig, token, pos, kv, greedy: bool = True):
    """One autoregressive step writing cache row `pos`.  In the decode loop
    (runtime/decode_graph.py) token ([1] int) and pos (int64 [1]) are its
    device tensors, which the CUDA graph of the step holds; host ints are
    filled in on the device."""
    if not isinstance(token, torch.Tensor):
        token = torch.full((1,), int(token), dtype=torch.int64, device=kv.device)
    tok = token.reshape(1).long()
    embed = embed_rows(params["embed"], tok)
    hidden, kv = decoder_forward(params, cfg, embed, pos, 1, kv)
    if greedy:
        return greedy_head(params, cfg, hidden[:1])[0], kv
    return logits_at(params, cfg, hidden, 0), kv


# ---------------------------------------------------------------------------
# Batched decoder (segments / serving): the batch dimension is written into
# the products, the cache is [L, 2, B, KH, K, D], and every row writes at the
# same cache position (the left-padded and natural layouts make it
# batch-uniform), so each layer's cache write is one plain slice write.
# ---------------------------------------------------------------------------


def make_batched_kv(cfg: ModelConfig, batch: int, kv_cap: int, dtype=torch.bfloat16,
                    device=None):
    """Batched KV cache [L, 2, B, KH, K, D] (bf16 or f32); dtype int8 (--kv8)
    gives a QuantKV: int8 values plus per-row f32 scales [L, 2, B, KH, K]."""
    return kv_zeros((cfg.dec_layers, 2, batch, cfg.dec_kv_heads, kv_cap, cfg.dec_head_dim),
                    dtype, device)


def build_embeds_batched(params, ids: torch.Tensor, audio: torch.Tensor,
                         audio_start: torch.Tensor, audio_len: torch.Tensor) -> torch.Tensor:
    """`build_embeds` per row: ids [B, T], audio [B, A, H], audio_start /
    audio_len [B] -> [B, T, H] f32."""
    emb = embed_rows(params["embed"], ids)
    rel = torch.arange(ids.shape[1], device=ids.device)[None, :] - audio_start[:, None]
    in_audio = (rel >= 0) & (rel < audio_len[:, None])
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None]
    audio_rows = audio[rows, rel.clamp(0, audio.shape[1] - 1)].float()
    return torch.where(in_audio[..., None], audio_rows, emb)


def batched_decoder_forward(params, cfg: ModelConfig, embeds: torch.Tensor, start_pos,
                            kv, rope_start: torch.Tensor, kv_min: torch.Tensor,
                            fresh_prefill: bool = False, prompt_max=None, region_start=None):
    """Run the layer stack over `embeds` [B, T, H] written into cache rows
    start_pos..start_pos+T-1 of every batch row.  start_pos is a host int,
    or, for the decode step, an int64 device tensor [1]: then the attention
    reads the whole cache under a mask built from it
    (`fa.batched_decode_attention`, the JAX package's full-Kcap two-part
    form; an int8 cache widened whole) and the rows are written with
    index_copy_, so nothing depends on the position's value on the host.

    rope_start [B]: logical position of block row 0 per row (negative for
    left-pad rows).  kv_min [B]: cache rows below it are left-pad garbage.
    fresh_prefill: start_pos == 0 and the whole context is this block ->
    kernel B4.  Otherwise, on a bf16 / f32 cache, a block of T > 1 runs
    kernel B5 against the cache (with the natural-layout mask prompt_max /
    region_start when given), and a decode step (T == 1) the plain two-part
    attention; on an int8 cache (QuantKV) both run the two-part attention
    on the widened rows.  There is no size crossover.
    Returns (hidden [B, T, H] f32, kv) -- kv updated in place.
    """
    B, T, _ = embeds.shape
    H, KH, D = cfg.dec_heads, cfg.dec_kv_heads, cfg.dec_head_dim
    eps = cfg.rms_norm_eps
    device_pos = isinstance(start_pos, torch.Tensor)
    if device_pos:  # its owner checks the rows against the cache on the host
        rows = start_pos.reshape(1) + torch.arange(T, device=embeds.device)
    elif start_pos + T > kv.shape[4]:
        raise ValueError(f"cache rows {start_pos}..{start_pos + T} past its {kv.shape[4]}")
    kv8 = isinstance(kv, QuantKV)
    positions = rope_start[:, None] + torch.arange(T, device=embeds.device)[None, :]
    cos, sin = rope_tables(positions, D, cfg.rope_theta)       # [B, T, D]
    layers = params["layers"]
    h = embeds.float()
    for i in range(layers["wqkv"].shape[0]):
        lp = {key: take(val, i) for key, val in layers.items()}
        xn = rms_norm(h, lp["input_ln"], eps)
        qkv = linear(xn, lp["wqkv"])
        q = qkv[..., : H * D].reshape(B, T, H, D)
        k = qkv[..., H * D : (H + KH) * D].reshape(B, T, KH, D)
        v = qkv[..., (H + KH) * D :].reshape(B, T, KH, D)
        q = apply_rope_neox(rms_norm(q, lp["q_norm"], eps), cos, sin).contiguous()
        k = apply_rope_neox(rms_norm(k, lp["k_norm"], eps), cos, sin).contiguous()
        v = v.contiguous()
        k_cache, v_cache = kv[i, 0], kv[i, 1]                  # [B, KH, K, D]
        if fresh_prefill:
            attn = fa.batched_causal_flash_attention(q, k, v, kv_min)
        elif device_pos:
            if kv8:
                k_cache, v_cache = kv_read(k_cache), kv_read(v_cache)
            attn = fa.batched_decode_attention(q, k, v, k_cache, v_cache, start_pos, kv_min,
                                               prompt_max, region_start)
        elif T > 1 and not kv8:
            attn = fa.batched_cache_flash_attention(q, k, v, k_cache, v_cache, start_pos, kv_min,
                                                    prompt_max, region_start)
        else:
            # a block at a host position on an int8 cache (or a one-row
            # block): the JAX package's two-part attention, which it
            # computes outside any kernel -- the same function as B5's
            # plain version, here on the int8 rows widened to f32 with
            # their scales
            if kv8:
                k_cache, v_cache = kv_read(k_cache, start_pos), kv_read(v_cache, start_pos)
            attn = fa.batched_cache_attention_plain(q, k, v, k_cache, v_cache, start_pos,
                                                    kv_min, prompt_max, region_start)
        h = h + linear(attn.reshape(B, T, H * D), lp["wo"])
        h = h + _dense_ffn(rms_norm(h, lp["post_ln"], eps), lp)
        kv_write(kv[i, 0], rows if device_pos else start_pos, k.transpose(1, 2))
        kv_write(kv[i, 1], rows if device_pos else start_pos, v.transpose(1, 2))
    return h, kv


def batched_logits(params, cfg: ModelConfig, hidden_rows: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm + lm_head for one row per batch element [B, H] -> [B, V] f32."""
    return linear(rms_norm(hidden_rows, params["final_norm"], cfg.rms_norm_eps),
                  params["lm_head"])


def _greedy_or_logits(params, cfg: ModelConfig, hidden_rows: torch.Tensor, greedy: bool):
    if greedy:
        return greedy_head(params, cfg, hidden_rows)
    return batched_logits(params, cfg, hidden_rows)


def batched_prefill(params, cfg: ModelConfig, embeds, kv, rope_start, kv_min,
                    greedy: bool = True):
    """Fresh prefill at start_pos 0 (kernel B4): the left-padded layout puts
    each row's last prompt token at T-1.  Returns (tokens | logits [B, ...], kv)."""
    T = embeds.shape[1]
    hidden, kv = batched_decoder_forward(params, cfg, embeds, 0, kv, rope_start, kv_min,
                                         fresh_prefill=True)
    return _greedy_or_logits(params, cfg, hidden[:, T - 1], greedy), kv


def batched_prefill_delta(params, cfg: ModelConfig, embeds, start_pos: int, kv, rope_start,
                          kv_min, greedy: bool = True, last_rows=None, prompt_max=None,
                          region_start=None):
    """Delta prefill (kernel B5; the two-part attention on an int8 cache):
    the block writes cache rows [start_pos, start_pos + T) of every row and
    attends each row's frozen context [kv_min[b], start_pos).  Row b's last
    prompt token is at T - 1 (left-padded) or at last_rows[b] (natural
    layout).  Returns (tokens | logits, kv)."""
    T = embeds.shape[1]
    hidden, kv = batched_decoder_forward(params, cfg, embeds, start_pos, kv, rope_start, kv_min,
                                         prompt_max=prompt_max, region_start=region_start)
    if last_rows is None:
        h_last = hidden[:, T - 1]
    else:
        h_last = hidden[torch.arange(hidden.shape[0], device=hidden.device), last_rows.long()]
    return _greedy_or_logits(params, cfg, h_last, greedy), kv


def batched_decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, pos: torch.Tensor, kv,
                        rope_offset, kv_min, prompt_max=None, region_start=None) -> torch.Tensor:
    """One greedy step of every row: tokens [B] int at the batch-uniform
    cache row pos (an int64 device tensor [1]); the rope position of row b
    is pos - rope_offset[b].  Returns the next tokens, int32 [B] (kernel K6
    or K7).  Nothing is read back to the host: the batched decode loop
    (runtime/decode_graph.py) captures it as one CUDA graph."""
    embeds = embed_rows(params["embed"], tokens.long())[:, None, :]
    hidden, _ = batched_decoder_forward(params, cfg, embeds, pos, kv, pos - rope_offset, kv_min,
                                        prompt_max=prompt_max, region_start=region_start)
    return greedy_head(params, cfg, hidden[:, 0])
