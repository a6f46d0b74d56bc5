"""Chat-template prompt assembly (host side, token ids only).

Port of smolvision_tpu/runtime/prompt.py: the ASR, streaming and thinker
layouts.

Token constants from qwen_asr.c:388-409 and qwen25_omni.c:78-93.  Layout
(qwen_asr.c transcribe_segment / stream_impl / thinker paths):

  ASR:     PREFIX_HEAD [prompt] PREFIX_TAIL [audio x N] SUFFIX_BASE
           [force-lang + <asr_text>] [past-text + <asr_text>]
  stream:  PREFIX_HEAD [prompt] PREFIX_TAIL [audio x N] SUFFIX_BASE
           [force-lang + <asr_text>] [rolled-back raw tokens]
  Thinker audio: PREFIX_HEAD [prompt] PREFIX_TAIL [audio] SUFFIX_BASE
  Thinker text:  PREFIX_HEAD [prompt] USER_HEAD [user] USER_TAIL
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from smolvision_tpu_torch.config import ModelConfig, TOKEN_ASR_TEXT

# <|im_start|> system \n
PREFIX_HEAD = [151644, 8948, 198]
# <|im_end|> \n <|im_start|> user \n <|audio_start|>
PREFIX_TAIL = [151645, 198, 151644, 872, 198, 151669]
# <|audio_end|> <|im_end|> \n <|im_start|> assistant \n
SUFFIX_BASE = [151670, 151645, 198, 151644, 77091, 198]
# <|im_end|> \n <|im_start|> user \n
THINKER_USER_HEAD = [151645, 198, 151644, 872, 198]
# <|im_end|> \n <|im_start|> assistant \n
THINKER_USER_TAIL = [151645, 198, 151644, 77091, 198]
# Qwen2.5-Omni variants: different audio boundary token ids
Q25_PREFIX_TAIL = [151645, 198, 151644, 872, 198, 151647]
Q25_SUFFIX_BASE = [151648, 151645, 198, 151644, 77091, 198]


def _tails(cfg: ModelConfig) -> Tuple[List[int], List[int]]:
    if cfg.family == "q25":
        return Q25_PREFIX_TAIL, Q25_SUFFIX_BASE
    return PREFIX_TAIL, SUFFIX_BASE


def build_asr_prompt(
    cfg: ModelConfig,
    n_audio: int,
    prompt_tokens: Sequence[int] = (),
    force_tokens: Sequence[int] = (),
    past_tokens: Optional[Sequence[int]] = None,
) -> Tuple[List[int], int]:
    """Returns (ids, audio_start).  `ids[audio_start : audio_start+n_audio]`
    are audio_pad placeholders to be replaced by encoder embeddings.

    force_tokens already includes the trailing <asr_text> marker (see
    Engine.prepare_prompt).  past_tokens (segmented/streaming conditioning)
    get a fresh <asr_text> appended (qwen_asr.c:746-759)."""
    prefix_tail, suffix_base = _tails(cfg)
    ids = list(PREFIX_HEAD) + list(prompt_tokens) + list(prefix_tail)
    audio_start = len(ids)
    ids += [cfg.audio_pad_token] * n_audio
    ids += list(suffix_base)
    ids += list(force_tokens)
    if past_tokens:
        ids += list(past_tokens)
        ids.append(TOKEN_ASR_TEXT)
    return ids, audio_start


def build_stream_prompt(
    cfg: ModelConfig,
    n_audio: int,
    prompt_tokens: Sequence[int] = (),
    force_tokens: Sequence[int] = (),
    prefix_tokens: Sequence[int] = (),
) -> Tuple[List[int], int]:
    """Streaming layout (qwen_asr.c:1751-1805): like ASR but the rolled-back
    raw-token prefix is appended verbatim (NO extra <asr_text>; the prefix
    already contains the language/<asr_text> lead from earlier chunks)."""
    prefix_tail, suffix_base = _tails(cfg)
    ids = list(PREFIX_HEAD) + list(prompt_tokens) + list(prefix_tail)
    audio_start = len(ids)
    ids += [cfg.audio_pad_token] * n_audio
    ids += list(suffix_base)
    ids += list(force_tokens)
    ids += list(prefix_tokens)
    return ids, audio_start


def build_thinker_audio_prompt(
    cfg: ModelConfig, n_audio: int, prompt_tokens: Sequence[int] = ()
) -> Tuple[List[int], int]:
    """Thinker audio path: no <asr_text> gating suffix (qwen_asr.c:2404-2448)."""
    prefix_tail, suffix_base = _tails(cfg)
    ids = list(PREFIX_HEAD) + list(prompt_tokens) + list(prefix_tail)
    audio_start = len(ids)
    ids += [cfg.audio_pad_token] * n_audio
    ids += list(suffix_base)
    return ids, audio_start


def build_thinker_text_prompt(
    cfg: ModelConfig, user_tokens: Sequence[int], prompt_tokens: Sequence[int] = ()
) -> List[int]:
    return (
        list(PREFIX_HEAD) + list(prompt_tokens)
        + THINKER_USER_HEAD + list(user_tokens) + THINKER_USER_TAIL
    )
