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
    would overrun it;
  * on a mesh (engine.serving_mesh, parallel/mesh.py) a group's rows pad to
    a multiple of dp (pad rows repeat the last segment and give no text
    and no perf counts); each data rank prefills and decodes its own rows
    and the first tokens and every chunk's tokens are all-gathered, so
    every rank takes the same host decisions.  Under dp > 1 the group
    encode splits its clips over "data" (the encoder's sequence
    parallelism: every rank encodes its share at the group's token bucket,
    then the audio rows are all-gathered; windows are hard, so no clip's
    arithmetic depends on the split).

Front end (`_use_device_mel`, the JAX package's gate with the card in the
place of its TPU): a qwen3 batch of more than two clips on bf16 weights on
the card takes the device log-mel -- the clips reflect-padded and packed
to f16 on the host, one upload from pinned memory (`_upload_audio`),
`ops/mel.log_mel_batch` on the card, the conv stem over every clip's
blocks and the tails sliced on the card (`_encode_batch_device_mel`).
Otherwise, and always under SMOLVISION_DEVICE_MEL=0, the host numpy mel
(on threads for B > 2); SMOLVISION_DEVICE_MEL=1 forces the device route
on any device.  f16 audio keeps ~2^-11 relative precision: device-mel
tokens can part from the single-clip path's at a near tie.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from smolvision_tpu_torch.config import (
    EOS_TOKEN_IDS,
    HOP_LENGTH,
    N_FFT,
    NUM_MEL_BINS,
    TOKEN_ASR_TEXT,
    conv_out_width,
)
from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
from smolvision_tpu_torch.models import qwen3_encoder as enc_mod
from smolvision_tpu_torch.ops.collectives import all_gather_cat, gather_host
from smolvision_tpu_torch.ops.mel import log_mel, log_mel_batch, num_frames, reflect_pad
from smolvision_tpu_torch.parallel import batch as pbatch
from smolvision_tpu_torch.parallel import mesh as mesh_mod
from smolvision_tpu_torch.runtime import prompt as prompt_mod
from smolvision_tpu_torch.runtime.buckets import bucket, bucket64, window_bucket

BATCH_DECODE_CHUNK = 64


def _now_ms() -> float:
    return time.monotonic() * 1000.0


def _conv_bucket(n: int) -> int:
    """Conv-stem block-count bucket: pow2 below 64, 64-granular above."""
    return bucket(n, 4) if n < 64 else -(-n // 64) * 64


def _conv_partial_tails(engine, rems, tails_of):
    """Group the clips' tail chunks by width (rems[b] frames, 0 for no tail)
    and run each width group through the conv stem once, at its true width.
    `tails_of(width, idxs)` gives that group's [n, 128, width] mel tensor
    (host tails uploaded, or tails sliced on the card).  Returns
    (partial_rows {b: (block, row_start, n_rows)}, partial_blocks [flat
    [rows, d] tensors])."""
    partial_rows = {}
    partial_blocks = []
    by_width = {}
    for b, rem in enumerate(rems):
        if rem:
            by_width.setdefault(rem, []).append(b)
    for w, idxs in by_width.items():
        out = enc_mod.conv_stem(engine.enc_params, tails_of(w, idxs), engine.cfg)
        n, rows_w, d_ = out.shape
        blk = len(partial_blocks)
        partial_blocks.append(out.reshape(n * rows_w, d_))
        for j, b in enumerate(idxs):
            partial_rows[b] = (blk, j * rows_w, rows_w)
    return partial_rows, partial_blocks


def _rank_share(engine, items: Sequence) -> list:
    """This data rank's share of a group's clips under the encoder's sequence
    parallelism (engine._enc_sp_mesh, dp > 1): the clips padded to a
    multiple of dp with copies of the last, then the rank's block.  All of
    them off a mesh."""
    sp = getattr(engine, "_enc_sp_mesh", None)
    if sp is None:
        return list(items)
    padded = list(items) + [items[-1]] * ((-len(items)) % mesh_mod.mesh_dp(sp))
    return padded[sp.rows(len(padded))]


def _encode_split(engine, frames: Sequence[int], mine, encode):
    """The group encode under the encoder's sequence parallelism: `encode(mine,
    tcap)` runs this rank's share (`_rank_share`) at the whole group's token
    bucket and the rows are all-gathered over "data".  Off a mesh,
    `encode(mine, None)` alone.  frames: every clip's mel frames.  Returns
    (audio_stack [B, cap, H], n_tokens list)."""
    sp = getattr(engine, "_enc_sp_mesh", None)
    if sp is None:
        return encode(mine, None)
    cfg = engine.cfg
    n_tokens = [enc_mod.total_encoder_tokens(f, cfg) for f in frames]
    tcap = max(window_bucket(n, cfg.window_token_size()) for n in n_tokens)
    out, _ = encode(mine, tcap)
    out = all_gather_cat(out, sp.group(mesh_mod.DATA_AXIS))
    return out[: len(frames)], n_tokens


@torch.inference_mode()
def _encode_batch(engine, mels: Sequence[np.ndarray]):
    """Encode B [128, F] mel spectrograms.  Returns (audio_stack [B, cap, H],
    n_tokens list).  Under the encoder's sequence parallelism
    (engine._enc_sp_mesh, dp > 1) each data rank encodes its share of the
    clips and the rows are all-gathered."""
    if len(mels) == 1:
        a, n = engine.encode_mel(mels[0])
        return a[None], [n]
    return _encode_split(engine, [m.shape[1] for m in mels], _rank_share(engine, mels),
                         lambda mine, tcap: _encode_group(engine, mine, tcap))


def _encode_group(engine, mels: Sequence[np.ndarray], tcap: Optional[int] = None):
    """The batched encode of `mels` (one conv-stem call for the full chunks,
    one per tail width, one windowed encoder call); `tcap` fixes the token
    bucket (default: the largest clip's)."""
    cfg = engine.cfg
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
        engine, [m.shape[1] % chunk for m in mels],
        lambda w, idxs: torch.from_numpy(np.stack(
            [np.ascontiguousarray(mels[b][:, -w:], dtype=np.float32) for b in idxs])
        ).to(engine.device))

    full_starts = np.cumsum([0] + full_counts[:-1]).tolist()
    return _pool_and_encode(engine, len(mels), full_tok, n_full_sum, full_starts, full_counts,
                            partial_rows, partial_blocks, tcap)


# --- the device front end ---------------------------------------------------

def _use_device_mel(cfg, B: int, param_dtype, device) -> bool:
    """The gate of the device log-mel front end (the JAX package's, with the
    card in the place of its TPU): on by default for qwen3 batches of more
    than two clips on bf16 weights on the card.  SMOLVISION_DEVICE_MEL=0
    forces the host mel everywhere (the single-clip path's arithmetic); =1
    forces the device mel on any device (the CPU tests).  An f32 engine
    (--f32, the reference's arithmetic family) takes the host mel unless
    forced."""
    dm_env = os.environ.get("SMOLVISION_DEVICE_MEL", "")
    if dm_env == "0" or cfg.family == "q25" or B <= 2:
        return False
    if dm_env == "1":
        return True
    return param_dtype != torch.float32 and torch.device(device).type == "cuda"


@dataclass
class UploadedAudio:
    """A group's padded f16 audio on the device (`_upload_audio`).  buf [B,
    fcap * HOP + N_FFT] f16 and frames (each clip's mel frames) are this
    data rank's share of the clips; fcap its frame cap.  host: the source
    (pinned on the card), referenced until its copy has completed; host_ms:
    the host's reflect-pad and pack.  copy: the copy's CUDA events (start,
    end), None on the CPU; side: the copy ran on a side stream, which the
    encode's stream must wait for."""

    buf: torch.Tensor
    frames: List[int]
    fcap: int
    host: Optional[torch.Tensor]
    host_ms: float
    copy: Optional[tuple] = None
    side: bool = False

    def take(self) -> None:
        """Make the current stream wait for a side stream's copy and let the
        buffer be used on it (`record_stream`)."""
        if self.side:
            stream = torch.cuda.current_stream(self.buf.device)
            stream.wait_event(self.copy[1])
            self.buf.record_stream(stream)

    def release(self) -> None:
        """Drop the source once its copy has completed."""
        if self.copy is not None:
            self.copy[1].synchronize()
        self.host = None


def _upload_audio(engine, segments: Sequence[np.ndarray], stream=None) -> UploadedAudio:
    """The host stage of the device front end and its one upload: reflect-pad
    each clip (ops/mel.reflect_pad), pack to f16 (numpy's round to nearest
    even) into a pinned [B, fcap * HOP + N_FFT] buffer and copy it to the
    device, on `stream` (a side stream: serving issues the next group's
    upload while a decode chunk runs) or the current one.  fcap: the largest
    clip's frames rounded up to two conv chunks.  Under the encoder's
    sequence parallelism only this data rank's share is packed."""
    t0 = _now_ms()
    chunk = engine.cfg.enc_chunk_size
    segs = _rank_share(engine, segments)
    frames = [num_frames(len(s)) for s in segs]
    fcap = -(-max(frames) // (2 * chunk)) * (2 * chunk)
    pcap = fcap * HOP_LENGTH + N_FFT
    dev = engine.device
    cuda = dev.type == "cuda"
    host = torch.zeros((len(segs), pcap), dtype=torch.float16, pin_memory=cuda)
    view = host.numpy()
    for b, s in enumerate(segs):
        p = reflect_pad(np.asarray(s, dtype=np.float32))
        # len(p) = n + N_FFT can pass pcap (frames % (2 * chunk) == 0 with n %
        # HOP != 0); every frame reads below pcap - HOP, so the tail is unused
        m = min(len(p), pcap)
        view[b, :m] = p[:m].astype(np.float16)
    host_ms = _now_ms() - t0
    if not cuda:
        return UploadedAudio(host.to(dev), frames, fcap, host, host_ms)
    events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    with torch.cuda.stream(stream or torch.cuda.current_stream(dev)):
        events[0].record()
        buf = host.to(dev, non_blocking=True)
        events[1].record()
    return UploadedAudio(buf, frames, fcap, host, host_ms, copy=events, side=stream is not None)


@torch.inference_mode()
def _encode_batch_device_mel(engine, segments: Sequence[np.ndarray],
                             uploaded: Optional[UploadedAudio] = None):
    """The batched encode with the log-mel on the device: the f16 audio
    (`uploaded`, or uploaded here), `log_mel_batch` over the group, the conv
    stem over every clip's fcap // chunk blocks (blocks past a clip's frames
    are computed and never gathered), the tails grouped by width and sliced
    on the device, then `_pool_and_encode`.  Returns (audio_stack [B, cap,
    H], n_tokens list); under the encoder's sequence parallelism each data
    rank runs its share and the rows are all-gathered."""
    up = uploaded if uploaded is not None else _upload_audio(engine, segments)
    return _encode_split(engine, [num_frames(len(s)) for s in segments], up,
                         lambda up, tcap: _device_mel_group(engine, up, tcap))


def _device_mel_group(engine, up: UploadedAudio, tcap: Optional[int]):
    """One rank's group of `_encode_batch_device_mel`, its mel ms counted
    into engine.perf (the upload copy's and the log-mel's device spans
    settled later)."""
    cfg = engine.cfg
    dev = engine.device
    chunk = cfg.enc_chunk_size
    B, fcap = len(up.frames), up.fcap
    perf = engine.perf
    up.take()
    perf.mel_ms += up.host_ms
    if up.copy is not None:
        perf.device_pair("front.upload", *up.copy, into="mel_ms")
    with perf.span("front.mel", device=True, into="mel_ms"):
        mel_t = log_mel_batch(up.buf, torch.tensor(up.frames, device=dev), fcap)  # [B, 128, fcap]
    nc = fcap // chunk
    blocks = mel_t.reshape(B, NUM_MEL_BINS, nc, chunk).transpose(1, 2).reshape(
        B * nc, NUM_MEL_BINS, chunk)
    ncap = _conv_bucket(B * nc)
    if ncap > B * nc:
        blocks = torch.cat([blocks, blocks.new_zeros((ncap - B * nc, NUM_MEL_BINS, chunk))])
    full_tok = enc_mod.conv_stem(engine.enc_params, blocks, cfg)

    full_counts = [f // chunk for f in up.frames]
    partial_rows, partial_blocks = _conv_partial_tails(
        engine, [f % chunk for f in up.frames],
        lambda w, idxs: torch.stack([mel_t[b, :, full_counts[b] * chunk :
                                           full_counts[b] * chunk + w] for b in idxs]))
    out = _pool_and_encode(engine, B, full_tok, B * nc, [b * nc for b in range(B)],
                           full_counts, partial_rows, partial_blocks, tcap)
    with perf.span("front.wait_upload"):
        up.release()
    return out


def _pool_and_encode(engine, B, full_tok, n_pool_blocks, full_starts, full_counts,
                     partial_rows, partial_blocks, tcap: Optional[int] = None):
    """Flatten the conv outputs into one row pool, gather each clip's rows
    into [B, tcap, d] (the gather index is built on the host) and run the
    windowed encoder over all clips at once."""
    cfg = engine.cfg
    tpc = cfg.tokens_per_chunk
    wts = cfg.window_token_size()
    n_tokens = [full_counts[b] * tpc + (partial_rows[b][2] if b in partial_rows else 0)
                for b in range(B)]
    tcap = tcap or max(window_bucket(n, wts) for n in n_tokens)
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
    mesh = getattr(engine, "serving_mesh", None)
    n_real = len(segments)
    # the rows split over "data": pad to a multiple of dp with copies of the
    # last segment (rows are independent; pad rows are dropped below)
    segments = list(segments) + [segments[-1]] * ((-n_real) % mesh_mod.mesh_dp(mesh))
    B = len(segments)
    mine = slice(0, B) if mesh is None else mesh.rows(B)
    Bl = mine.stop - mine.start
    model_axis = mesh_mod.model_group(engine)
    perf = engine.perf

    # --- encode all segments as one batch: the device front end, or the
    # host mel (on threads for B > 2: numpy's FFT releases the GIL)
    enc_t0 = _now_ms()
    if _use_device_mel(cfg, B, engine.param_dtype, dev):
        if engine.verbose >= 1 and not getattr(engine, "_device_mel_noted", False):
            engine._device_mel_noted = True
            print("Batch mel: device f16 log-mel (tokens may part from the single-file host "
                  "mel at a near tie; SMOLVISION_DEVICE_MEL=0 forces the host mel)",
                  file=sys.stderr, flush=True)
        enc_stack, n_tokens_list = _encode_batch_device_mel(engine, segments)
    else:
        if B > 2:
            with ThreadPoolExecutor(max_workers=min(16, B)) as pool:
                mels = list(pool.map(log_mel, segments))
        else:
            mels = [log_mel(seg) for seg in segments]
        perf.mel_ms += _now_ms() - enc_t0
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
    enc_stack = enc_stack[mine]
    audio_stack = (enc_stack[:, :acap] if acap <= enc_cap else
                   torch.cat([enc_stack, enc_stack.new_zeros(
                       (Bl, acap - enc_cap, enc_stack.shape[2]))], dim=1))

    def i32(values):
        return torch.tensor(values[mine], dtype=torch.int32, device=dev)

    astart = i32([starts[b] + pads[b] for b in range(B)])
    alen = i32(n_tokens_list)
    rope_start = i32([-p for p in pads])
    kv_min = i32(pads)

    # decode reads B x kcap KV rows per step: size to the decode horizon and
    # let the loop grow the cache past it
    kcap = bucket64(tcap + min(engine.max_tokens, 2 * BATCH_DECODE_CHUNK) + 1)
    kv = pbatch.make_batched_kv(cfg, Bl, kcap, engine.batched_kv_dtype, dev, group=model_axis)
    engine._sync()
    perf.settle_mel()
    perf.encode_ms += _now_ms() - enc_t0

    dec_t0 = _now_ms()
    embeds = dec_mod.build_embeds_batched(engine.dec_params,
                                          torch.from_numpy(ids_arr[mine]).to(dev),
                                          audio_stack, astart, alen, model_axis)
    first, kv = pbatch.batched_prefill(engine.dec_params, cfg, embeds, kv, rope_start, kv_min,
                                       group=model_axis)
    perf.fresh_prefills += 1
    first_host = gather_host(first.cpu().numpy(), mesh_mod.data_group(engine),
                                      dev).reshape(-1)
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
            loop = pbatch.batched_decode_loop(engine.dec_params, cfg, kv, Bl, perf,
                                              group=model_axis,
                                              data_group=mesh_mod.data_group(engine))
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
    return rows[:n_real]
