"""Qwen3 LLM decoder in torch: prefill + decode step, single and batched.

Port of smolvision_tpu/models/qwen3_decoder.py (reference semantics:
qwen_asr_decoder.c, MODEL.md:156-227), dense and MoE, also for the
Qwen2.5-Omni decoder (qwen25_omni_decoder.c: a QKV bias, no q/k norms, an
untied lm_head) on the single-stream paths; the batched forwards refuse it,
as the JAX package's serving does (Qwen2.5-Omni runs through the thinker).

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
  * an MoE decoder (Qwen3-Omni-30B-A3B) runs models/moe.py's FFN in its
    MoE layers (on int8 expert stacks under --q8 and in the --spec
    draft; the host-offload forward, models/moe_offload.py, runs this
    module's attention half and FFNs layer by layer with
    `block_positions`); a mixed stack (decoder_sparse_step > 1) picks the FFN per
    layer with a plain Python branch (`layer_params`).  Rows that may take
    expert capacity are the JAX package's `row_valid`: below valid_len in a
    single block; at or above kv_min in a batched one and, with the
    natural layout, outside [prompt_max, region_start).  A forward at a
    device start (a graph step's) takes the MoE formulation that reads
    nothing back (`moe.moe_ffn`'s graph_safe).
  * tensor parallelism (parallel/mesh.py, batched forwards only): with a
    "model" axis group a rank holds its part of every weight and of the
    cache's KV heads, runs H/tp query and KH/tp KV heads (B4 / B5 at those
    shapes) and sums its f32 partials after wo and after the FFN over the
    axis; the embedding looks up its own vocabulary rows and sums; the
    greedy head reduces K6 / K7's packed keys with MAX.  A rank's slice of
    the interleaved fusion (parallel/mesh.interleave_decoder_for_tp) is
    [q; k; v] and [gate; up] of its own heads and channels, so it splits as
    the whole fusion does.
"""

from __future__ import annotations

import torch

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.device import resolve_device
from smolvision_tpu_torch.kernels import argmax_matvec as am
from smolvision_tpu_torch.kernels import flash_attention as fa
from smolvision_tpu_torch.models import moe
from smolvision_tpu_torch.ops.collectives import (all_gather_cat, group_rank, group_size, pmax,
                                                  psum)
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


def _split_qkv(qkv: torch.Tensor, H: int, KH: int, D: int):
    """The [q; k; v] output fusion qkv [..., (H + 2 KH) D] -> q [..., H, D],
    k / v [..., KH, D]."""
    lead = qkv.shape[:-1]
    return (qkv[..., : H * D].reshape(*lead, H, D),
            qkv[..., H * D : (H + KH) * D].reshape(*lead, KH, D),
            qkv[..., (H + KH) * D :].reshape(*lead, KH, D))


def _split_gate_up(gate_up: torch.Tensor):
    """[..., 2I] -> (gate [..., I], up [..., I]) of the [gate; up] fusion."""
    I = gate_up.shape[-1] // 2
    return gate_up[..., :I], gate_up[..., I:]


def _attn_block(lp, h, kv, layer: int, cfg: ModelConfig, cos, sin, rows, start_pos, kv_valid):
    """One layer's attention half: input RMSNorm -> fused QKV (+ its bias,
    Qwen2.5-Omni) -> per-head Q/K norm (Qwen3) -> RoPE -> causal GQA
    attention vs the cache -> o-proj residual.
    Writes this block's K/V rows into kv[layer] at `rows` (int64 [T], by
    index_copy_).  A decode step (T == 1, kernel B3) has start_pos as its
    int32 device copy [1]; a longer block (kernel B2) has start_pos and
    kv_valid as host ints or device tensors."""
    T = h.shape[0]
    H, KH, D = cfg.dec_heads, cfg.dec_kv_heads, cfg.dec_head_dim
    eps = cfg.rms_norm_eps
    xn = rms_norm(h, lp["input_ln"], eps)
    qkv = linear(xn, lp["wqkv"], lp.get("bqkv"))
    q, k, v = _split_qkv(qkv, H, KH, D)
    if "q_norm" in lp:
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
    """Fused-SwiGLU dense FFN on [T, H] activations (a rank's partial sum
    under a "model" axis: its channels of gate / up, its columns of w_down)."""
    gate, up = _split_gate_up(linear(xn, lp["w_gate_up"]))
    return linear(silu(gate) * up, lp["w_down"])


MOE_KEYS = ("router", "e_gate", "e_up", "e_down")
DENSE_FFN_KEYS = ("w_gate_up", "w_down")


def layer_params(params):
    """Each layer's weights as views of the stacks, in order.  The attention
    and norm stacks have one row per layer.  In an MoE decoder
    params["moe_layers"] (one bool per layer) says which layers are MoE:
    the expert stacks (MOE_KEYS) have one row per MoE layer, and a mixed
    stack's dense FFN (DENSE_FFN_KEYS) one per dense layer; a dense decoder
    has no "moe_layers".  Any stack may be a QuantW (--q8, the --spec
    draft); expert stacks left on the host (--moe-offload: None) are left
    out of the layers' dictionaries."""
    layers = params["layers"]
    n = layers["wqkv"].shape[0]
    is_moe = params.get("moe_layers") or (False,) * n
    shared = {k: v for k, v in layers.items() if k not in MOE_KEYS + DENSE_FFN_KEYS}
    out, rows = [], {True: 0, False: 0}
    for i in range(n):
        lp = {k: take(v, i) for k, v in shared.items()}
        j = rows[is_moe[i]]
        rows[is_moe[i]] += 1
        for k in MOE_KEYS if is_moe[i] else DENSE_FFN_KEYS:
            if layers.get(k) is not None:
                lp[k] = take(layers[k], j)
        out.append(lp)
    return out


def _ffn(xn, lp, cfg: ModelConfig, row_valid, graph_safe: bool, group=None):
    """The layer's FFN on [T, H] activations: MoE where the layer has a
    router.  Under a "model" axis (`group`) each rank returns its partial
    sum (its channels, or its experts' share), which the caller reduces."""
    if "router" in lp:
        return moe.moe_ffn(xn, lp, cfg, row_valid, graph_safe, group=group)
    return _dense_ffn(xn, lp)


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
    Rows >= valid_len are junk; their cache rows are masked until overwritten,
    and they take no MoE expert capacity.
    """
    graph_safe = isinstance(start_pos, torch.Tensor)
    at = block_positions(cfg, embeds.shape[0], start_pos, valid_len, kv, embeds.device)
    row_valid = (torch.arange(embeds.shape[0], device=embeds.device) < valid_len
                 if params.get("moe_layers") else None)
    h = embeds.float()
    for i, lp in enumerate(layer_params(params)):
        h = _attn_block(lp, h, kv, i, cfg, *at)
        h = h + _ffn(rms_norm(h, lp["post_ln"], cfg.rms_norm_eps), lp, cfg, row_valid,
                     graph_safe)
    return h, kv


def block_positions(cfg: ModelConfig, T: int, start_pos, valid_len, kv, device):
    """What `_attn_block` needs of a block of T rows at start_pos (see
    decoder_forward): (cos, sin, rows, start_pos, kv_valid) -- the RoPE
    tables, the cache rows (int64 [T]), and the start and kv_valid as B2 /
    B3 take them (a decode step's start as an int32 device tensor [1])."""
    if isinstance(kv, QuantKV):
        raise ValueError("the int8 KV cache (--kv8) is batched-path only (make_batched_kv)")
    if T == 1 and not isinstance(start_pos, torch.Tensor):
        start_pos = torch.full((1,), start_pos, dtype=torch.int64, device=device)
    if isinstance(start_pos, torch.Tensor):
        start_pos = start_pos.reshape(1)
    elif start_pos < 0 or start_pos + T > kv.shape[2]:
        raise ValueError(f"cache rows {start_pos}..{start_pos + T} past its {kv.shape[2]}")
    rows = start_pos + torch.arange(T, device=device)
    cos, sin = rope_tables(rows, cfg.dec_head_dim, cfg.rope_theta)
    kv_valid = start_pos + valid_len if T > 1 else None
    if isinstance(start_pos, torch.Tensor):   # B2 / B3 read int32s from device memory
        start_pos = start_pos.to(torch.int32)
        kv_valid = None if kv_valid is None else kv_valid.to(torch.int32)
    return cos, sin, rows, start_pos, kv_valid


def logits_at(params, cfg: ModelConfig, hidden: torch.Tensor, row: int) -> torch.Tensor:
    """Final RMSNorm + lm_head logits [V] (f32) for one row of the hidden states."""
    h = rms_norm(hidden[row], params["final_norm"], cfg.rms_norm_eps)
    return linear(h[None], params["lm_head"])[0]


def greedy_head(params, cfg: ModelConfig, hidden_rows: torch.Tensor,
                group=None) -> torch.Tensor:
    """The greedy token of each row of hidden_rows [R, H]: int32 [R].

    Final RMSNorm, then the fused lm_head matvec + argmax (kernel K6 for a
    bf16 / f32 lm_head, K7 for an int8 one): argmax(linear(...)) without the
    logits.  An int8 head computes the dequantized product bf16(h) .
    bf16(q) * s, the JAX package's `proj` below 1024 rows (a batch of 1024
    rows or more would take its int8 x int8 branch instead).

    Under a "model" axis `group` the table is this rank's vocabulary rows:
    the kernel returns the packed keys of its rows' maxima, indices offset
    to the whole vocabulary, and their MAX over the axis is the
    single-device argmax, ties to the lowest index (kernels/argmax_matvec)."""
    h = rms_norm(hidden_rows, params["final_norm"], cfg.rms_norm_eps).contiguous()
    w = params["lm_head"]
    w, scale = (w.q, w.s) if isinstance(w, QuantW) else (w, None)
    if group is None:
        return am.argmax_matvec(h, w, scale)
    keys = am.argmax_matvec(h, w, scale, offset=group_rank(group) * w.shape[0])
    return am.key_index(pmax(keys, group))


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
                    device=None, group=None):
    """Batched KV cache [L, 2, B, KH, K, D] (bf16 or f32); dtype int8 (--kv8)
    gives a QuantKV: int8 values plus per-row f32 scales [L, 2, B, KH, K].
    Under a "model" axis `group` of n ranks a rank's cache holds KH / n heads."""
    return kv_zeros((cfg.dec_layers, 2, batch, cfg.dec_kv_heads // group_size(group), kv_cap,
                     cfg.dec_head_dim), dtype, device)


def embed_tokens(emb, ids: torch.Tensor, group=None) -> torch.Tensor:
    """Embedding rows of ids, f32 [..., H].  Under a "model" axis `group`
    the table is this rank's vocabulary rows: it looks up the ids inside
    them, zeros the others and sums over the axis (exact: one rank holds
    each row)."""
    if group is None:
        return embed_rows(emb, ids)
    V = emb.shape[0]
    local = ids - group_rank(group) * V
    inside = (local >= 0) & (local < V)
    rows = embed_rows(emb, local.clamp(0, V - 1))
    return psum(torch.where(inside[..., None], rows, 0.0).contiguous(), group)


def build_embeds_batched(params, ids: torch.Tensor, audio: torch.Tensor,
                         audio_start: torch.Tensor, audio_len: torch.Tensor,
                         group=None) -> torch.Tensor:
    """`build_embeds` per row: ids [B, T], audio [B, A, H], audio_start /
    audio_len [B] -> [B, T, H] f32 (`group`: a vocabulary-sharded table,
    `embed_tokens`)."""
    emb = embed_tokens(params["embed"], ids, group)
    rel = torch.arange(ids.shape[1], device=ids.device)[None, :] - audio_start[:, None]
    in_audio = (rel >= 0) & (rel < audio_len[:, None])
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None]
    audio_rows = audio[rows, rel.clamp(0, audio.shape[1] - 1)].float()
    return torch.where(in_audio[..., None], audio_rows, emb)


def _batched_row_valid(start_pos, T: int, kv_min, prompt_max, region_start) -> torch.Tensor:
    """[B * T] bool: the block's rows that may take MoE expert capacity --
    not left pads (below kv_min) and, in the natural layout, not end pads
    in [prompt_max, region_start)."""
    pos = (start_pos.reshape(1) if isinstance(start_pos, torch.Tensor) else start_pos) + \
        torch.arange(T, device=kv_min.device)
    valid = pos[None] >= kv_min[:, None]
    if prompt_max is not None:
        rs = torch.as_tensor(region_start, device=kv_min.device)
        rs = rs[:, None] if rs.dim() == 1 else rs
        valid = valid & ((pos[None] < prompt_max[:, None]) | (pos[None] >= rs))
    return valid.reshape(-1)


def batched_decoder_forward(params, cfg: ModelConfig, embeds: torch.Tensor, start_pos,
                            kv, rope_start: torch.Tensor, kv_min: torch.Tensor,
                            fresh_prefill: bool = False, prompt_max=None, region_start=None,
                            group=None):
    """Run the layer stack over `embeds` [B, T, H] written into cache rows
    start_pos..start_pos+T-1 of every batch row.  start_pos is a host int,
    or an int64 device tensor [1] (the decode step's position, multistream's
    round prefill graph's start): then the rows are written with
    index_copy_ and the attention reads its start from the device, so
    nothing depends on the position's value on the host.

    rope_start [B]: logical position of block row 0 per row (negative for
    left-pad rows).  kv_min [B]: cache rows below it are left-pad garbage.
    fresh_prefill: start_pos == 0 and the whole context is this block ->
    kernel B4.  Otherwise, on a bf16 / f32 cache, a block of T > 1 runs
    kernel B5 against the cache (with the natural-layout mask prompt_max /
    region_start when given; at a device start B5 reads it from device
    memory).  A decode step (T == 1), and any block on an int8 cache
    (QuantKV), runs the plain two-part attention: at a device position the
    JAX package's full-Kcap form (`fa.batched_decode_attention`, an int8
    cache widened whole), at a host int on the rows below it.  There is no
    size crossover.  An MoE layer's FFN takes the B * T rows as one block
    (graph-safe at a device position).

    Tensor parallelism: `group` is the "model" axis whose n ranks each hold
    a 1/n part of the interleaved weights (parallel/mesh.shard_params) and
    of the cache's KV heads.  A rank runs H/n query and KH/n KV heads
    (RoPE, the q/k norms, B4 / B5 and the cache all local), and its partial
    products after wo and after the FFN are summed over the axis in f32.
    Returns (hidden [B, T, H] f32, kv) -- kv updated in place.
    """
    if cfg.family == "q25":
        raise ValueError("continuous serving supports the qwen3 family only "
                         "(q25 checkpoints route through the thinker path)")
    B, T, _ = embeds.shape
    n = group_size(group)
    H, KH, D = cfg.dec_heads // n, cfg.dec_kv_heads // n, cfg.dec_head_dim
    eps = cfg.rms_norm_eps
    device_pos = isinstance(start_pos, torch.Tensor)
    if device_pos:  # its owner checks the rows against the cache on the host
        rows = start_pos.reshape(1) + torch.arange(T, device=embeds.device)
    elif start_pos + T > kv.shape[4]:
        raise ValueError(f"cache rows {start_pos}..{start_pos + T} past its {kv.shape[4]}")
    kv8 = isinstance(kv, QuantKV)
    positions = rope_start[:, None] + torch.arange(T, device=embeds.device)[None, :]
    cos, sin = rope_tables(positions, D, cfg.rope_theta)       # [B, T, D]
    row_valid = (_batched_row_valid(start_pos, T, kv_min, prompt_max, region_start)
                 if params.get("moe_layers") else None)
    h = embeds.float()
    for i, lp in enumerate(layer_params(params)):
        xn = rms_norm(h, lp["input_ln"], eps)
        q, k, v = _split_qkv(linear(xn, lp["wqkv"]), H, KH, D)
        q = apply_rope_neox(rms_norm(q, lp["q_norm"], eps), cos, sin).contiguous()
        k = apply_rope_neox(rms_norm(k, lp["k_norm"], eps), cos, sin).contiguous()
        v = v.contiguous()
        k_cache, v_cache = kv[i, 0], kv[i, 1]                  # [B, KH, K, D]
        if fresh_prefill:
            attn = fa.batched_causal_flash_attention(q, k, v, kv_min)
        elif T > 1 and not kv8:
            attn = fa.batched_cache_flash_attention(q, k, v, k_cache, v_cache, start_pos, kv_min,
                                                    prompt_max, region_start)
        elif device_pos:
            if kv8:
                k_cache, v_cache = kv_read(k_cache), kv_read(v_cache)
            attn = fa.batched_decode_attention(q, k, v, k_cache, v_cache, start_pos, kv_min,
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
        h = h + psum(linear(attn.reshape(B, T, H * D), lp["wo"]), group)
        xn = rms_norm(h, lp["post_ln"], eps).reshape(B * T, -1)
        ffn = _ffn(xn, lp, cfg, row_valid, device_pos, group)
        h = h + psum(ffn, group).reshape(B, T, -1)
        kv_write(kv[i, 0], rows if device_pos else start_pos, k.transpose(1, 2))
        kv_write(kv[i, 1], rows if device_pos else start_pos, v.transpose(1, 2))
    return h, kv


def batched_logits(params, cfg: ModelConfig, hidden_rows: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Final RMSNorm + lm_head for one row per batch element [B, H] -> [B, V]
    f32 (under a "model" axis `group`, the ranks' vocabulary shards
    gathered)."""
    logits = linear(rms_norm(hidden_rows, params["final_norm"], cfg.rms_norm_eps),
                    params["lm_head"])
    return all_gather_cat(logits, group, dim=-1)


def _greedy_or_logits(params, cfg: ModelConfig, hidden_rows: torch.Tensor, greedy: bool,
                      group=None):
    if greedy:
        return greedy_head(params, cfg, hidden_rows, group)
    return batched_logits(params, cfg, hidden_rows, group)


def batched_prefill(params, cfg: ModelConfig, embeds, kv, rope_start, kv_min,
                    greedy: bool = True, group=None):
    """Fresh prefill at start_pos 0 (kernel B4): the left-padded layout puts
    each row's last prompt token at T-1.  Returns (tokens | logits [B, ...], kv).
    group: the "model" axis (batched_decoder_forward)."""
    T = embeds.shape[1]
    hidden, kv = batched_decoder_forward(params, cfg, embeds, 0, kv, rope_start, kv_min,
                                         fresh_prefill=True, group=group)
    return _greedy_or_logits(params, cfg, hidden[:, T - 1], greedy, group), kv


def batched_prefill_delta(params, cfg: ModelConfig, embeds, start_pos, kv, rope_start,
                          kv_min, greedy: bool = True, last_rows=None, prompt_max=None,
                          region_start=None, group=None):
    """Delta prefill (kernel B5; the two-part attention on an int8 cache):
    the block writes cache rows [start_pos, start_pos + T) of every row and
    attends each row's frozen context [kv_min[b], start_pos).  start_pos is
    a host int or an int64 device tensor [1] (multistream's round prefill
    graph; its owner checks the rows against the cache).  Row b's last
    prompt token is at T - 1 (left-padded) or at last_rows[b] (natural
    layout).  Returns (tokens | logits, kv)."""
    T = embeds.shape[1]
    hidden, kv = batched_decoder_forward(params, cfg, embeds, start_pos, kv, rope_start, kv_min,
                                         prompt_max=prompt_max, region_start=region_start,
                                         group=group)
    if last_rows is None:
        h_last = hidden[:, T - 1]
    else:
        h_last = hidden[torch.arange(hidden.shape[0], device=hidden.device), last_rows.long()]
    return _greedy_or_logits(params, cfg, h_last, greedy, group), kv


def batched_decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, pos: torch.Tensor, kv,
                        rope_offset, kv_min, prompt_max=None, region_start=None,
                        group=None) -> torch.Tensor:
    """One greedy step of every row: tokens [B] int at the batch-uniform
    cache row pos (an int64 device tensor [1]); the rope position of row b
    is pos - rope_offset[b].  Returns the next tokens, int32 [B] (kernel K6
    or K7).  Nothing is read back to the host: the batched decode loop
    (runtime/decode_graph.py) captures it as one CUDA graph; under a "model"
    axis `group` its collectives keep it eager."""
    embeds = embed_tokens(params["embed"], tokens.long(), group)[:, None, :]
    hidden, _ = batched_decoder_forward(params, cfg, embeds, pos, kv, pos - rope_offset, kv_min,
                                        prompt_max=prompt_max, region_start=region_start,
                                        group=group)
    return greedy_head(params, cfg, hidden[:, 0], group)
