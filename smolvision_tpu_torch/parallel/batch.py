"""Batched model entry points (port of smolvision_tpu/parallel/batch.py).

Segments (-S mode) and independent clips are each an independent prompt
with its own KV rows; the batch dimension is written into the decoder's
products (models/qwen3_decoder.py batched_*).  The batch axis splits over
the "data" axis of a mesh (parallel/mesh.py: each rank holds its rows), and
`group` is the "model" axis, whose ranks each hold a part of the weights,
of the experts and of the cache's KV heads (parallel/mesh.model_group).
"""

from __future__ import annotations

import torch

from smolvision_tpu_torch.config import EOS_TOKEN_IDS, ModelConfig
from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
from smolvision_tpu_torch.ops.quant import QuantKV, kv_grow_k  # noqa: F401
from smolvision_tpu_torch.runtime.decode_graph import BatchedPrefillGraph, DecodeLoop, WaveGraph

# KV cache layout [L, 2, B, KH, K, D] -- see models/qwen3_decoder.py
make_batched_kv = dec_mod.make_batched_kv


def batched_prefill(params, cfg: ModelConfig, embeds, kv, rope_start=None, kv_min=None,
                    greedy: bool = True, group=None):
    """Fresh prefill at start_pos 0: embeds [B, Tcap, H] (left-padded: each
    row's last prompt token at Tcap-1), kv [L, 2, B, KH, K, D]; rope_start /
    kv_min [B] default to zeros (no left padding).
    Returns (tokens_or_logits [B, ...], kv)."""
    B = embeds.shape[0]
    zeros = torch.zeros((B,), dtype=torch.int32, device=embeds.device)
    return dec_mod.batched_prefill(params, cfg, embeds, kv,
                                   zeros if rope_start is None else rope_start,
                                   zeros if kv_min is None else kv_min, greedy=greedy,
                                   group=group)


def batched_decode_loop(params, cfg: ModelConfig, kv, batch: int, perf=None,
                        natural: bool = False, group=None, data_group=None) -> DecodeLoop:
    """The batched greedy decode loop on cache `kv` (runtime/decode_graph.py:
    one CUDA graph of the step on the card, replayed per token).  Its
    inputs per chunk: rope_offset / kv_min [B], and with `natural` (the
    natural layout of serving) prompt_max / region_start [B].  The loop
    holds `kv`: make a new one when the cache is replaced.  On a mesh, B is
    this data rank's rows and `data_group` makes each chunk's host read
    global; a step with a "model" axis `group` (tp > 1) holds collectives
    and runs eagerly, never captured."""
    names = ("rope_offset", "kv_min") + (("prompt_max", "region_start") if natural else ())
    zeros = torch.zeros((batch,), dtype=torch.int32)
    return DecodeLoop(lambda tok, pos, **x: dec_mod.batched_decode_step(
                          params, cfg, tok, pos, kv, group=group, **x),
                      batch, kv, kv.shape[4], kv.device, perf, {name: zeros for name in names},
                      data_group=data_group, eager=group is not None)


def batched_prefill_graph(params, cfg: ModelConfig, kv, embeds: torch.Tensor,
                          perf=None, stream=None, warm: bool = True) -> BatchedPrefillGraph:
    """Multistream's round prefill on cache `kv` at a device start
    (runtime/decode_graph.py: its first call eager -- unless `warm` is
    False, then captured --, its second captured as a CUDA graph, later
    ones replayed, on capture stream `stream` if given):
    `run(embeds, start, rope_start=, kv_min=, last_rows=, prompt_max=,
    region_start=)`, each input [B] int32, gives the greedy first tokens of
    `batched_prefill_delta`, int32 [B].  One graph per block shape: embeds
    [B, W, H] fixes B and W.  The graph holds `kv`: make a new one when the
    cache is replaced."""
    names = ("rope_start", "kv_min", "last_rows", "prompt_max", "region_start")
    zeros = torch.zeros((embeds.shape[0],), dtype=torch.int32)
    return BatchedPrefillGraph(lambda e, at, **x: dec_mod.batched_prefill_delta(
                                   params, cfg, e, at, kv, **x)[0],
                               embeds, {name: zeros for name in names}, perf, stream, warm)


def serving_wave_graph(params, cfg: ModelConfig, kv, audio: torch.Tensor, pcap: int,
                       perf=None) -> WaveGraph:
    """Serving's admission wave on the small cache `kv` [L, 2, Gcap, KH,
    pcap, D] (runtime/decode_graph.py: its first call eager, its second
    captured as a CUDA graph, later ones replayed): `run(audio, ints)`
    builds the embeddings (`build_embeds_batched`) and prefills them at a
    device start of 0 (`batched_prefill_delta`, each row's prompt length
    its prompt_max, region_start past the cache), giving the greedy first
    tokens, int32 [Gcap].  One graph per wave shape: audio [Gcap, acap, H]
    fixes Gcap and acap.  The graph holds `kv`, which every wave of its
    shape overwrites."""
    def forward(audio, at, ids, audio_start, audio_len, last_rows, prompt_max):
        embeds = dec_mod.build_embeds_batched(params, ids, audio, audio_start, audio_len)
        zeros = torch.zeros_like(audio_start)
        # region_start as [Gcap] rows: the int8 cache's attention at a device
        # start takes a tensor
        past = torch.full_like(audio_start, 1 << 30)
        return dec_mod.batched_prefill_delta(params, cfg, embeds, at, kv, zeros, zeros,
                                             last_rows=last_rows, prompt_max=prompt_max,
                                             region_start=past)[0]

    return WaveGraph(forward, audio, pcap, perf)


def batched_decode_chunk(params, cfg: ModelConfig, tokens, pos: int, kv, n_steps_cap: int,
                         rope_offset=None, kv_min=None, n_steps=None, prompt_max=None,
                         region_start=None, row_active=None, group=None):
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
    loop = batched_decode_loop(params, cfg, kv, B, natural=prompt_max is not None,
                               group=group)
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
