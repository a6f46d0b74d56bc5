"""Segmented transcription driver + silence compaction (host logic).

Port of smolvision_tpu/runtime/segment.py, which ports the *behavior* of
qwen_asr.c's segmented mode:
  * energy-based split search: lowest-energy 100 ms window within +/-
    search_sec of each target boundary (find_split_point, qwen_asr.c:617-643),
  * <=128 segments, 0.5 s zero-pad minimum (qwen_asr.c:1003-1011),
  * optional past-text conditioning with collapse detection & retry
    (should_retry_unconditioned_segment, qwen_asr.c:844-867) and fail-open
    disable after 2 collapses (qwen_asr.c:1062-1068),
  * boundary space insertion heuristics (qwen_asr.c:869-898),
  * adaptive RMS silence compaction (--skip-silence, qwen_asr.c:437-565).

Pure numpy/host Python.  With conditioning off, the segments are
independent and decode as one batch (runtime/batch_segments.py: kernel B4
prefill); with it on, they run one by one through Engine.transcribe_segment
(kernels B2 and B3).  The JAX package's optional native keep-mask fast path
is not copied: the numpy mask is its exact twin.
"""

from __future__ import annotations

from typing import List, Optional

import sys

import numpy as np

from smolvision_tpu_torch.config import SAMPLE_RATE

ENERGY_WINDOW_MS = 100
MAX_SEGMENTS = 128


def _seg_now() -> float:
    import time

    return time.monotonic() * 1000.0


def compact_silence(samples: np.ndarray) -> np.ndarray:
    """Drop long silent spans while keeping short pauses.

    Adaptive RMS gate: 10 ms windows, EMA smoothing (alpha 0.2), threshold =
    25th-percentile noise floor x1.8 clamped to [-54 dBFS, 0.025], <50 ms
    voice spikes rejected, 30 ms speech-edge padding, first 600 ms of each
    silence kept, in the reference's f32 arithmetic."""
    n = len(samples)
    if n <= 0:
        return samples
    win = 160  # 10 ms
    keep = _silence_keep_mask_numpy(samples)
    mask = np.repeat(keep, win)[:n]
    out = samples[mask]
    if len(out) == 0:
        out = samples[: min(n, SAMPLE_RATE // 2)]
    return np.ascontiguousarray(out, dtype=np.float32)


def _silence_keep_mask_numpy(samples: np.ndarray) -> np.ndarray:
    """Keep mask per 10 ms window (the JAX package's numpy mask)."""
    n = len(samples)
    win = 160  # 10 ms
    base_thresh = 0.002
    max_thresh = 0.025
    alpha = 0.2
    min_voice_windows = 5
    pad_voice_windows = 3
    pass_windows = 60

    n_win = (n + win - 1) // win
    padded_len = n_win * win
    # f32 SEQUENTIAL per-window energy — the reference's exact arithmetic
    # (qwen_asr.c:461-472).  The trailing zero pad is rounding-neutral
    # (x + 0.0f == x), so all windows share one vectorized walk: accumulate
    # column-by-column, which reproduces C's sample-order f32 rounding.
    buf = np.zeros(padded_len, dtype=np.float32)
    buf[:n] = samples
    cols = np.ascontiguousarray(buf.reshape(n_win, win).T)
    acc = np.zeros(n_win, dtype=np.float32)
    for j in range(win):
        acc += cols[j] * cols[j]
    lens = np.full(n_win, win, dtype=np.float32)
    lens[-1] = (n - (n_win - 1) * win) or win
    rms = np.sqrt(acc / lens)

    # EMA smoothing — sequential in f32, as the reference (qwen_asr.c:475-479)
    a32 = np.float32(alpha)
    one_m = np.float32(1.0) - a32
    smooth = np.empty_like(rms)
    s = rms[0]
    for i, r in enumerate(rms):
        s = one_m * s + a32 * r
        smooth[i] = s

    noise_floor = np.sort(smooth)[int((n_win - 1) * 0.25)]
    thresh = noise_floor * np.float32(1.8)
    thresh = min(max(thresh, np.float32(base_thresh)), np.float32(max_thresh))
    is_voice = smooth > thresh

    # Reject short voice bursts
    i = 0
    while i < n_win:
        if not is_voice[i]:
            i += 1
            continue
        j = i
        while j < n_win and is_voice[j]:
            j += 1
        if j - i < min_voice_windows:
            is_voice[i:j] = False
        i = j

    # Edge padding
    padded = np.zeros(n_win, dtype=bool)
    idx = np.nonzero(is_voice)[0]
    for w in idx:
        padded[max(0, w - pad_voice_windows) : min(n_win, w + pad_voice_windows + 1)] = True

    keep = np.zeros(n_win, dtype=bool)
    silence_count = 0
    for w in range(n_win):
        if padded[w]:
            keep[w] = True
            silence_count = 0
        else:
            silence_count += 1
            if silence_count <= pass_windows:
                keep[w] = True
    return keep


def find_split_point(samples: np.ndarray, target: int, search_sec: float) -> int:
    """Lowest-energy 100 ms window (half-overlapping scan) near `target`."""
    n = len(samples)
    half = int(search_sec * SAMPLE_RATE)
    lo = max(0, target - half)
    hi = min(n, target + half)
    win = (ENERGY_WINDOW_MS * SAMPLE_RATE) // 1000  # 1600
    starts = np.arange(lo, hi - win + 1, win // 2)
    if len(starts) == 0:
        return target
    # per-window f32 SEQUENTIAL sum of squares — the reference's exact
    # arithmetic (qwen_asr.c:629-640); a prefix-sum formulation rounds
    # differently and can flip near-tie minima, shifting every downstream
    # segment boundary.  All windows are full width (starts + win <= hi <= n).
    wins = samples[starts[:, None] + np.arange(win)[None, :]].astype(np.float32)
    cols = np.ascontiguousarray(wins.T)
    acc = np.zeros(len(starts), dtype=np.float32)
    for j in range(win):
        acc += cols[j] * cols[j]
    energy = acc / np.float32(win)
    best = int(np.argmin(energy))  # first minimum, as C's strict '<' scan
    return int(starts[best]) + win // 2


def split_points(samples: np.ndarray, segment_sec: float, search_sec: float) -> List[int]:
    """Segment boundaries incl. 0 and len(samples); empty if no splitting."""
    n = len(samples)
    search = min(search_sec, segment_sec / 2.0)
    target = int(segment_sec * SAMPLE_RATE)
    margin = int(search * SAMPLE_RATE)
    if segment_sec <= 0 or n <= target + margin:
        return [0, n]
    splits = [0]
    pos = 0
    while pos + target + margin < n and len(splits) < MAX_SEGMENTS - 1:
        split = find_split_point(samples, pos + target, search)
        splits.append(split)
        pos = split
    splits.append(n)
    return splits


def should_retry_unconditioned(full_result: str, seg_text: Optional[str],
                               core_samples: int, n_text_tokens: int) -> bool:
    """Conditioning-collapse heuristics (qwen_asr.c:844-867)."""
    if not seg_text:
        return True
    core_sec = core_samples / SAMPLE_RATE
    if core_sec >= 8.0:
        min_tokens = max(int(core_sec * 1.75), 12)
        if n_text_tokens < min_tokens:
            return True
    # length gate is BYTES (C strlen, qwen_asr.c:862), not characters —
    # 20 CJK chars are 60 UTF-8 bytes and must trigger the retry
    if (full_result and len(seg_text.encode("utf-8")) >= 48
            and seg_text in full_result):
        return True
    return False


_ASCII_SPACE = frozenset(b" \t\n\r\v\f")
_ASCII_PUNCT = frozenset(
    b"!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")  # C-locale ispunct == ASCII punct


def _should_insert_boundary_space(prev_ch: str, next_ch: str) -> bool:
    """Byte-level heuristic, as the reference (qwen_asr.c:869-876): the C
    engine tests the last BYTE of the accumulated text and the first BYTE
    of the new segment with C-locale isspace/ispunct, under which any
    UTF-8 continuation/lead byte (>=0x80) is neither — so e.g. a segment
    starting with U+3000 still gets a separating space."""
    if not prev_ch or not next_ch:
        return False
    pb = prev_ch.encode("utf-8")[-1]
    nb = next_ch.encode("utf-8")[0]
    if pb in _ASCII_SPACE or nb in _ASCII_SPACE:
        return False
    if nb in _ASCII_PUNCT:
        return False
    return True


def transcribe_audio(engine, samples: np.ndarray) -> Optional[str]:
    """Full offline transcription with optional segmentation.

    Mirrors qwen_transcribe_audio (qwen_asr.c:900-1112): silence skip, split
    search, per-segment fresh KV, past-text conditioning with retry/disable,
    boundary stitching, callback routing."""
    engine.perf.reset()
    engine.perf.audio_ms = 1000.0 * len(samples) / SAMPLE_RATE

    if engine.skip_silence:
        compacted = compact_silence(samples)
        if engine.verbose >= 1:
            used = 100.0 * len(compacted) / max(len(samples), 1)
            print(f"Silence skip: used {used:.1f}%, skipped {100 - used:.1f}% "
                  f"({len(samples)} -> {len(compacted)} samples)", file=sys.stderr, flush=True)
        samples = compacted

    engine.prepare_prompt()
    splits = split_points(samples, engine.segment_sec, engine.search_sec)

    if len(splits) == 2:
        text, _ = engine.transcribe_segment(samples)
        return text

    if engine.verbose >= 2:
        print(f"Splitting into {len(splits) - 1} segments", file=sys.stderr, flush=True)

    min_samples = SAMPLE_RATE // 2

    # Fast path: with conditioning OFF, segments are independent — decode
    # them as one batch (runtime/batch_segments.py) so the per-step weight
    # streaming is amortized across segments.  The reference has no batched
    # mode; its sequential behavior is preserved when conditioning is on.
    if (not engine.past_text_conditioning and getattr(engine, "batch_segments", True)
            and len(splits) > 2):
        from smolvision_tpu_torch.runtime.batch_segments import transcribe_segments_batched

        seg_t0 = _seg_now()
        segs = []
        for s in range(len(splits) - 1):
            seg = samples[splits[s] : splits[s + 1]]
            if len(seg) < min_samples:
                seg = np.concatenate([seg, np.zeros(min_samples - len(seg), np.float32)])
            segs.append(seg)
        texts = transcribe_segments_batched(engine, segs)
        engine.perf.total_ms += _seg_now() - seg_t0
        result = ""
        for seg_text in texts:
            if not seg_text:
                continue
            need_space = _should_insert_boundary_space(
                result[-1] if result else "", seg_text[0])
            if need_space:
                result += " "
                if engine.token_cb:
                    engine.token_cb(b" ")
            result += seg_text
            if engine.token_cb:
                engine.token_cb(seg_text.encode("utf-8"))
        return result
    result = ""
    use_past = engine.past_text_conditioning
    do_cleanup = engine.past_text_conditioning
    collapses = 0
    saved_cb = engine.token_cb
    tok = engine.tokenizer

    for s in range(len(splits) - 1):
        core_start, core_end = splits[s], splits[s + 1]
        seg = samples[core_start:core_end]
        if len(seg) < min_samples:
            seg = np.concatenate([seg, np.zeros(min_samples - len(seg), np.float32)])

        past_tokens = None
        if use_past and result:
            past_tokens = tok.encode(result)

        if do_cleanup:
            engine.token_cb = None  # buffer; emit finalized text below
        elif saved_cb:
            # fast path: stream tokens immediately, maybe with one separator
            # byte semantics throughout, as segment_emit_cb
            # (qwen_asr.c:884-898, :1032-1033): last byte of the result and
            # first byte of the piece under C-locale isspace/ispunct
            state = {"first": True}
            prepend_space = bool(result) and (
                result[-1].encode("utf-8")[-1] not in _ASCII_SPACE)

            def _cb(piece: bytes, _state=state, _prepend=prepend_space):
                if _state["first"]:
                    _state["first"] = False
                    if _prepend and piece:
                        c0 = piece[0]
                        if c0 not in _ASCII_SPACE and c0 not in _ASCII_PUNCT:
                            saved_cb(b" ")
                saved_cb(piece)

            engine.token_cb = _cb

        seg_text, seg_tokens = engine.transcribe_segment(seg, past_tokens)

        if (do_cleanup and use_past and past_tokens
                and should_retry_unconditioned(result, seg_text,
                                               core_end - core_start, seg_tokens)):
            collapses += 1
            if engine.verbose >= 2:
                print(f"Segment {s + 1}: retrying without past-text conditioning",
                      file=sys.stderr, flush=True)
            seg_text, seg_tokens = engine.transcribe_segment(seg, None)
            if collapses >= 2:
                use_past = False
                if engine.verbose >= 2:
                    print("Segment mode: disabling past text conditioning", file=sys.stderr, flush=True)

        engine.token_cb = saved_cb
        if not seg_text:
            continue
        # ASCII whitespace only (C isspace byte loop, qwen_asr.c:1080) —
        # str.lstrip() would also eat U+3000/U+00A0, which the C engine keeps
        seg_text = seg_text.lstrip(" \t\n\r\v\f") if do_cleanup else seg_text
        if not seg_text:
            continue

        need_space = _should_insert_boundary_space(
            result[-1] if result else "", seg_text[0])
        if need_space:
            result += " "
            if do_cleanup and saved_cb:
                saved_cb(b" ")
        result += seg_text
        if do_cleanup and saved_cb:
            saved_cb(seg_text.encode("utf-8"))

    engine.token_cb = saved_cb
    return result

