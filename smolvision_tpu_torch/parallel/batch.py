"""Batched model entry points (port of smolvision_tpu/parallel/batch.py).

Segments (-S mode) and independent clips are each an independent prompt
with its own KV rows; the batch dimension is written into the decoder's
products (models/qwen3_decoder.py batched_*).  The port runs on one card:
there is no mesh, so the JAX package's tensor- and expert-parallel options
(`tp`, `ep`) are not taken.
"""

from __future__ import annotations

import torch

from smolvision_tpu_torch.config import EOS_TOKEN_IDS, ModelConfig
from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
from smolvision_tpu_torch.ops.quant import QuantKV, kv_grow_k  # noqa: F401
from smolvision_tpu_torch.runtime.decode_graph import DecodeLoop

# KV cache layout [L, 2, B, KH, K, D] -- see models/qwen3_decoder.py
make_batched_kv = dec_mod.make_batched_kv


def batched_prefill(params, cfg: ModelConfig, embeds, kv, rope_start=None, kv_min=None,
                    greedy: bool = True):
    """Fresh prefill at start_pos 0: embeds [B, Tcap, H] (left-padded: each
    row's last prompt token at Tcap-1), kv [L, 2, B, KH, K, D]; rope_start /
    kv_min [B] default to zeros (no left padding).
    Returns (tokens_or_logits [B, ...], kv)."""
    B = embeds.shape[0]
    zeros = torch.zeros((B,), dtype=torch.int32, device=embeds.device)
    return dec_mod.batched_prefill(params, cfg, embeds, kv,
                                   zeros if rope_start is None else rope_start,
                                   zeros if kv_min is None else kv_min, greedy=greedy)


def batched_decode_loop(params, cfg: ModelConfig, kv, batch: int, perf=None,
                        natural: bool = False) -> DecodeLoop:
    """The batched greedy decode loop on cache `kv` (runtime/decode_graph.py:
    one CUDA graph of the step on the card, replayed per token).  Its
    inputs per chunk: rope_offset / kv_min [B], and with `natural` (the
    natural layout of serving) prompt_max / region_start [B].  The loop
    holds `kv`: make a new one when the cache is replaced."""
    names = ("rope_offset", "kv_min") + (("prompt_max", "region_start") if natural else ())
    zeros = torch.zeros((batch,), dtype=torch.int32)
    return DecodeLoop(lambda tok, pos, **x: dec_mod.batched_decode_step(params, cfg, tok, pos,
                                                                        kv, **x),
                      batch, kv, kv.shape[4], kv.device, perf, {name: zeros for name in names})


def batched_decode_chunk(params, cfg: ModelConfig, tokens, pos: int, kv, n_steps_cap: int,
                         rope_offset=None, kv_min=None, n_steps=None, prompt_max=None,
                         region_start=None, row_active=None):
    """Greedy-decode up to n_steps (<= n_steps_cap <= DECODE_CHUNK) tokens
    for every row, stopping once every active row has emitted an EOS, on a
    loop of its own (callers that decode many chunks keep a
    `batched_decode_loop`).  pos is the cache row shared by all rows; the
    rope position of row b is pos - rope_offset[b]; region_start is [B] or
    an int.  The contract of the JAX package's device while_loop: returns
    (buf [B, n_steps_cap] int32, count, last_tokens [B], kv)."""
    B = tokens.shape[0]
    dev = tokens.device
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    inputs = {"rope_offset": zeros if rope_offset is None else rope_offset,
              "kv_min": zeros if kv_min is None else kv_min}
    if prompt_max is not None:
        inputs.update(prompt_max=prompt_max, region_start=torch.as_tensor(region_start).expand(B))
    out = torch.zeros((B, n_steps_cap), dtype=torch.int32)
    steps = n_steps_cap if n_steps is None else min(int(n_steps), n_steps_cap)
    if steps <= 0:
        return out, 0, tokens.to(torch.int32), kv
    loop = batched_decode_loop(params, cfg, kv, B, natural=prompt_max is not None)
    buf, count, _ = loop.run(tokens, pos, steps, row_active, **inputs)
    out[:, :count] = torch.from_numpy(buf)
    return out, count, loop.tok.clone(), kv


def admit_rows(big, small, rows, G: int, src=None):
    """Copy `G` batch rows of `small` into `big` at row indices `rows[g]` (row
    axis 2 of the [L, 2, B, KH, K, D] batched cache), in place: one
    scalar-indexed block copy per row, never a scatter.  `small`'s K axis
    may be shorter than `big`'s (prompt-region admit).  `src[g]` (default g)
    selects which small row feeds rows[g].  An int8 cache (QuantKV) copies
    both leaves, the scales [L, 2, B, KH, K] with the same index."""
    leaves = zip(big, small) if isinstance(big, QuantKV) else [(big, small)]
    K = small.shape[4]
    for b_leaf, s_leaf in leaves:
        for g in range(G):
            sg = g if src is None else int(src[g])
            b_leaf[:, :, int(rows[g]), :, :K] = s_leaf[:, :, sg].to(b_leaf.dtype)
    return big


def trim_eos(row) -> list:
    """Cut a decoded row at the first EOS (host helper)."""
    out = []
    for t in row:
        t = int(t)
        if t in EOS_TOKEN_IDS:
            break
        out.append(t)
    return out
