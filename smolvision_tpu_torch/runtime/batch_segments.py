"""Batched segment transcription: decode B segments (or clips) together.

Port of the host-mel path of smolvision_tpu/runtime/batch_segments.py.  The
reference decodes -S segments one by one (qwen_asr.c:987); decoding them as
one batch reads the decoder weights once per step for all rows.  With
past-text conditioning on, segments depend on each other and stay
sequential (runtime/segment.py).

  * encode: every clip's full 100-frame chunks go through one conv-stem call,
    partial tail chunks one call per width; the windowed encoder then runs
    over all clips at a common token bucket, one kernel-B1 launch per layer
    for all clips' windows;
  * prefill: the left-padded layout puts every row's last prompt token at
    cache row tcap - 1, so decode positions are batch-uniform; kv_min = pad
    masks the pad rows and rope_start = -pad shifts each row's positions.
    One kernel-B4 launch per layer per length group;
  * decode: chunks of up to BATCH_DECODE_CHUNK steps, stopping once every
    row has emitted an EOS; the cache grows in 64-row steps when a chunk
    would overrun it.

The JAX package's device-mel front end (an option of its TPU backend) is
not ported: the host mel is its behaviour on every other backend.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from smolvision_tpu_torch.config import (
    EOS_TOKEN_IDS,
    HOP_LENGTH,
    NUM_MEL_BINS,
    TOKEN_ASR_TEXT,
    conv_out_width,
)
from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
from smolvision_tpu_torch.models import qwen3_encoder as enc_mod
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.parallel import batch as pbatch
from smolvision_tpu_torch.runtime import prompt as prompt_mod
from smolvision_tpu_torch.runtime.buckets import bucket, bucket64, window_bucket

BATCH_DECODE_CHUNK = 64


def _now_ms() -> float:
    return time.monotonic() * 1000.0


def _conv_bucket(n: int) -> int:
    """Conv-stem block-count bucket: pow2 below 64, 64-granular above."""
    return bucket(n, 4) if n < 64 else -(-n // 64) * 64


def _conv_partial_tails(engine, tails):
    """Group the clips' tail chunks ([128, rem] arrays, None for no tail) by
    width and run each width group through the conv stem once (a tail runs
    at its true width).  Returns (partial_rows {b: (block, row_start,
    n_rows)}, partial_blocks [flat [rows, d] tensors])."""
    partial_rows = {}
    partial_blocks = []
    by_width = {}
    for b, tail in enumerate(tails):
        if tail is not None:
            by_width.setdefault(tail.shape[1], []).append(b)
    for idxs in by_width.values():
        stack = torch.from_numpy(np.stack([tails[b] for b in idxs])).to(engine.device)
        out = enc_mod.conv_stem(engine.enc_params, stack, engine.cfg)
        n, rows_w, d_ = out.shape
        blk = len(partial_blocks)
        partial_blocks.append(out.reshape(n * rows_w, d_))
        for j, b in enumerate(idxs):
            partial_rows[b] = (blk, j * rows_w, rows_w)
    return partial_rows, partial_blocks


@torch.inference_mode()
def _encode_batch(engine, mels: Sequence[np.ndarray]):
    """Encode B [128, F] mel spectrograms.  Returns (audio_stack [B, cap, H],
    n_tokens list)."""
    cfg = engine.cfg
    if len(mels) == 1:
        a, n = engine.encode_mel(mels[0])
        return a[None], [n]

    chunk = cfg.enc_chunk_size
    full_counts = [m.shape[1] // chunk for m in mels]

    # every clip's full chunks: one host assembly, one upload, one conv call
    full_tok = None
    n_full_sum = sum(full_counts)
    if n_full_sum:
        arr = np.zeros((_conv_bucket(n_full_sum), NUM_MEL_BINS, chunk), dtype=np.float32)
        off = 0
        for m, n_full in zip(mels, full_counts):
            arr[off : off + n_full] = (m[:, : n_full * chunk]
                                       .reshape(m.shape[0], n_full, chunk).transpose(1, 0, 2))
            off += n_full
        full_tok = enc_mod.conv_stem(engine.enc_params, torch.from_numpy(arr).to(engine.device),
                                     cfg)

    partial_rows, partial_blocks = _conv_partial_tails(
        engine, [np.ascontiguousarray(m[:, n * chunk :], dtype=np.float32)
                 if m.shape[1] % chunk else None for m, n in zip(mels, full_counts)])

    full_starts = np.cumsum([0] + full_counts[:-1]).tolist()
    return _pool_and_encode(engine, len(mels), full_tok, n_full_sum, full_starts, full_counts,
                            partial_rows, partial_blocks)


def _pool_and_encode(engine, B, full_tok, n_pool_blocks, full_starts, full_counts,
                     partial_rows, partial_blocks):
    """Flatten the conv outputs into one row pool, gather each clip's rows
    into [B, tcap, d] (the gather index is built on the host) and run the
    windowed encoder over all clips at once."""
    cfg = engine.cfg
    tpc = cfg.tokens_per_chunk
    wts = cfg.window_token_size()
    n_tokens = [full_counts[b] * tpc + (partial_rows[b][2] if b in partial_rows else 0)
                for b in range(B)]
    tcap = max(window_bucket(n, wts) for n in n_tokens)
    d = cfg.enc_d_model

    pool_parts = []
    if n_pool_blocks:
        pool_parts.append(full_tok[:n_pool_blocks].reshape(-1, d))
    block_base = []
    off = n_pool_blocks * tpc
    for blk in partial_blocks:
        block_base.append(off)
        off += blk.shape[0]
        pool_parts.append(blk)
    R = off  # pool rows; row R is the zero pad row
    idx = np.full((B, tcap), R, dtype=np.int64)
    for b in range(B):
        n_f = full_counts[b] * tpc
        if n_f:
            idx[b, :n_f] = full_starts[b] * tpc + np.arange(n_f)
        if b in partial_rows:
            blk, row_start, nr = partial_rows[b]
            idx[b, n_f : n_f + nr] = block_base[blk] + row_start + np.arange(nr)
    pool = torch.cat(pool_parts + [pool_parts[0].new_zeros((1, d))], dim=0)
    x = pool[torch.from_numpy(idx).to(pool.device)]             # [B, tcap, d]
    out = enc_mod.encoder_transformer(engine.enc_params, x, n_tokens, cfg, wts)
    engine.perf.encodes += 1
    return out, n_tokens


def _estimate_prompt_len(cfg, n_samples: int, overhead: int) -> int:
    """A segment's prompt length from its sample count (mel frames -> conv
    tokens -> + the prompt's fixed tokens); exact enough for bucketing."""
    frames = max(n_samples // HOP_LENGTH, 1)
    chunk = cfg.enc_chunk_size
    tokens = (frames // chunk) * cfg.tokens_per_chunk
    if frames % chunk:
        tokens += conv_out_width(conv_out_width(conv_out_width(frames % chunk)))
    return tokens + overhead


def _length_groups(engine, segments: Sequence[np.ndarray]) -> List[List[int]]:
    """Partition segment indices into length-sorted sub-batches.

    A mixed batch pays B x (tcap_max - tcap_i) wasted prefill rows per short
    segment; a split pays one more group.  A DP over the length-sorted
    segments minimises sum_g (B_g * tcap_g + OVERHEAD), OVERHEAD (token
    rows, SMOLVISION_SUBBATCH_OVERHEAD, default 8192) standing for the fixed
    cost of a group.  Rows are independent, so any grouping gives the same
    tokens."""
    cfg = engine.cfg
    ids, _ = prompt_mod.build_asr_prompt(cfg, 16, engine._prompt_tokens, engine._force_tokens,
                                         None)
    overhead_tok = len(ids) - 16
    n = len(segments)
    est = sorted((bucket64(_estimate_prompt_len(cfg, len(s), overhead_tok)), i)
                 for i, s in enumerate(segments))
    caps = [c for c, _ in est]
    if caps[0] == caps[-1]:
        return [list(range(n))]
    overhead = int(os.environ.get("SMOLVISION_SUBBATCH_OVERHEAD", "8192"))
    dp = [0.0] + [float("inf")] * n
    cut = [0] * (n + 1)
    for i in range(1, n + 1):
        for j in range(i):
            c = dp[j] + (i - j) * caps[i - 1] + overhead
            if c < dp[i]:
                dp[i] = c
                cut[i] = j
    groups = []
    i = n
    while i > 0:
        j = cut[i]
        groups.append([est[k][1] for k in range(j, i)])
        i = j
    groups.reverse()
    return groups


def decode_segments_batched(engine, segments: Sequence[np.ndarray]) -> List[List[int]]:
    """The raw greedy token rows of independent audio segments, decoded in
    length-sorted batches, in input order: each row starts with the prefill
    token and ends at its first EOS or after engine.max_tokens tokens."""
    rows: List[Optional[List[int]]] = [None] * len(segments)
    for idxs in _length_groups(engine, segments):
        for i, row in zip(idxs, _decode_segment_group(engine, [segments[i] for i in idxs])):
            rows[i] = row
    return rows  # type: ignore[return-value]


def transcribe_segments_batched(engine, segments: Sequence[np.ndarray]) -> List[str]:
    """Transcribe independent audio segments batched (see
    `decode_segments_batched`).  Returns texts in input order."""
    return [gate_text(engine, row) for row in decode_segments_batched(engine, segments)]


def gate_text(engine, row: Sequence[int]) -> str:
    """Detokenize one decoded row: text after <asr_text> (or from the start
    when a language is forced), up to the first EOS.  Counts its text tokens
    into engine.perf."""
    past_asr = bool(engine._force_tokens)
    pieces = []
    for t in row:
        if t in EOS_TOKEN_IDS:
            break
        if t == TOKEN_ASR_TEXT:
            past_asr = True
        elif past_asr:
            pieces.append(engine.tokenizer.decode_piece(t))
    engine.perf.text_tokens += len(pieces)
    return b"".join(pieces).decode("utf-8", errors="replace").strip()


@torch.inference_mode()
def _decode_segment_group(engine, segments: Sequence[np.ndarray]) -> List[List[int]]:
    """One batched decode of segments sharing a prompt bucket: raw rows."""
    cfg = engine.cfg
    dev = engine.device
    engine.prepare_prompt()
    B = len(segments)
    perf = engine.perf

    # --- encode all segments as one batch (mel on host threads for B > 2:
    # numpy's FFT releases the GIL)
    enc_t0 = _now_ms()
    if B > 2:
        with ThreadPoolExecutor(max_workers=min(16, B)) as pool:
            mels = list(pool.map(log_mel, segments))
    else:
        mels = [log_mel(seg) for seg in segments]
    enc_stack, n_tokens_list = _encode_batch(engine, mels)
    id_rows, starts = [], []
    for n_audio in n_tokens_list:
        ids, audio_start = prompt_mod.build_asr_prompt(
            cfg, n_audio, engine._prompt_tokens, engine._force_tokens, None)
        id_rows.append(ids)
        starts.append(audio_start)

    # left-padded layout: cache index = logical position + pad
    tcap = bucket64(max(len(i) for i in id_rows))
    acap = bucket(max(n_tokens_list), 16)
    pads = [tcap - len(ids) for ids in id_rows]
    ids_arr = np.zeros((B, tcap), dtype=np.int64)
    for b, ids in enumerate(id_rows):
        ids_arr[b, pads[b] :] = ids
    enc_cap = enc_stack.shape[1]
    audio_stack = (enc_stack[:, :acap] if acap <= enc_cap else
                   torch.cat([enc_stack, enc_stack.new_zeros(
                       (B, acap - enc_cap, enc_stack.shape[2]))], dim=1))

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    astart = i32([starts[b] + pads[b] for b in range(B)])
    alen = i32(n_tokens_list)
    rope_start = i32([-p for p in pads])
    kv_min = i32(pads)

    # decode reads B x kcap KV rows per step: size to the decode horizon and
    # let the loop grow the cache past it
    kcap = bucket64(tcap + min(engine.max_tokens, 2 * BATCH_DECODE_CHUNK) + 1)
    kv = pbatch.make_batched_kv(cfg, B, kcap, engine.batched_kv_dtype, dev)
    engine._sync()
    perf.encode_ms += _now_ms() - enc_t0

    dec_t0 = _now_ms()
    embeds = dec_mod.build_embeds_batched(engine.dec_params, torch.from_numpy(ids_arr).to(dev),
                                          audio_stack, astart, alen)
    first, kv = pbatch.batched_prefill(engine.dec_params, cfg, embeds, kv, rope_start, kv_min)
    perf.fresh_prefills += 1
    first_host = first.cpu().numpy()
    perf.prefill_ms += _now_ms() - dec_t0

    rows: List[List[int]] = [[int(t)] for t in first_host]
    done = [int(t) in EOS_TOKEN_IDS for t in first_host]
    tokens = first
    pos = tcap  # the cache row every batch row writes next
    produced = 1
    loop = None  # the decode loop of the current cache (one CUDA graph on the card)
    while produced < engine.max_tokens and not all(done):
        steps = min(BATCH_DECODE_CHUNK, engine.max_tokens - produced)
        if pos + BATCH_DECODE_CHUNK + 1 > kcap:
            kcap = bucket64(pos + BATCH_DECODE_CHUNK + 64)
            kv = pbatch.kv_grow_k(kv, kcap)
            loop = None
        if loop is None:
            loop = pbatch.batched_decode_loop(engine.dec_params, cfg, kv, B, perf)
        t0 = _now_ms()
        buf_host, count, replays = loop.run(tokens, pos, steps, rope_offset=kv_min,
                                            kv_min=kv_min)
        tokens = loop.tok
        perf.batch_decode_ms += _now_ms() - t0
        perf.batch_decode_steps += replays
        if count == 0:
            break
        for b in range(B):
            if done[b]:
                continue
            for t in buf_host[b][:count]:
                t = int(t)
                rows[b].append(t)
                if t in EOS_TOKEN_IDS:
                    done[b] = True
                    break
        pos += count
        produced += count
    perf.decode_ms += _now_ms() - dec_t0
    return rows
