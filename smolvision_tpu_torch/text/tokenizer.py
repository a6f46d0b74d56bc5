"""GPT-2 style byte-level BPE tokenizer (encode + decode), parity-exact.

Port of smolvision_tpu/text/tokenizer.py: the pure-Python heap merge
only (the JAX package's optional native encode gives the same ids).

Behavioral contract (vs qwen_asr_tokenizer.c):
  * decode: vocab.json token string -> reverse byte map -> raw bytes.  Token
    pieces are *bytes*, not str: the reference streams raw bytes per token to
    stdout and multi-byte UTF-8 characters may legally span tokens
    (qwen_asr_tokenizer.c decode path).
  * encode: the whole input is treated as ONE BPE word — no GPT-2 regex
    pre-tokenization (qwen_asr_tokenizer.c:611-629).  This matters: the
    encoder only ever sees prompt/past text, and the reference's token ids
    are the parity target.
  * merge policy: repeatedly merge the lowest-rank adjacent pair.  The
    reference merges one occurrence at a time (first occurrence of the
    lowest-rank pair, qwen_asr_tokenizer.c:348-411); because a merge that
    *creates* a symbol always precedes merges that *use* it, this is
    equivalent to the standard merge-all-occurrences loop implemented here
    with a heap + doubly-linked list (O(n log n) instead of O(n^2)).
  * special ids (>= 151643) are absent from vocab.json and decode to b"".
"""

from __future__ import annotations

import heapq
import json
import os
from typing import Dict, List, Optional, Tuple


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte->unicode visible-char mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


class Tokenizer:
    def __init__(self, vocab_path: str, merges_path: Optional[str] = None):
        with open(vocab_path, encoding="utf-8") as f:
            vocab: Dict[str, int] = json.load(f)
        self.vocab = vocab
        # id -> raw bytes
        self.id_to_bytes: Dict[int, bytes] = {}
        for tok_str, tid in vocab.items():
            self.id_to_bytes[tid] = bytes(
                _BYTE_DECODER[c] for c in tok_str if c in _BYTE_DECODER
            )

        if merges_path is None:
            merges_path = os.path.join(os.path.dirname(vocab_path) or ".", "merges.txt")
        self.merge_ranks: Dict[Tuple[str, str], int] = {}
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                rank = 0
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    parts = line.split(" ")
                    if len(parts) != 2:
                        continue
                    self.merge_ranks[(parts[0], parts[1])] = rank
                    rank += 1

    # -- decode ------------------------------------------------------------

    def decode_piece(self, token_id: int) -> bytes:
        """Raw bytes for one token (b'' for unknown / special ids)."""
        return self.id_to_bytes.get(token_id, b"")

    def decode(self, token_ids) -> str:
        """Join token bytes, then decode UTF-8 (errors replaced)."""
        return b"".join(self.id_to_bytes.get(t, b"") for t in token_ids).decode(
            "utf-8", errors="replace"
        )

    # -- encode ------------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        if not text:
            return []
        raw = text.encode("utf-8")

        mapped = [_BYTE_ENCODER[b] for b in raw]
        symbols = self._merge(mapped)
        ids = []
        for sym in symbols:
            tid = self.vocab.get(sym)
            if tid is None:
                # Should not happen with a consistent vocab+merges pair; fall
                # back to per-byte tokens like the C byte-level fallback.
                for ch in sym:
                    btid = self.vocab.get(ch)
                    if btid is not None:
                        ids.append(btid)
            else:
                ids.append(tid)
        return ids

    def _merge(self, symbols: List[str]) -> List[str]:
        """Heap + doubly-linked-list lowest-rank-first BPE merge."""
        n = len(symbols)
        if n < 2 or not self.merge_ranks:
            return symbols
        sym = list(symbols)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        ranks = self.merge_ranks

        heap: List[Tuple[int, int, int]] = []  # (rank, left_index, version)
        version = [0] * n

        def push(i: int):
            j = nxt[i]
            if i < 0 or j < 0 or j >= n:
                return
            r = ranks.get((sym[i], sym[j]))
            if r is not None:
                heapq.heappush(heap, (r, i, version[i]))

        for i in range(n - 1):
            push(i)

        while heap:
            r, i, ver = heapq.heappop(heap)
            if not alive[i] or ver != version[i]:
                continue
            j = nxt[i]
            if j < 0 or not alive[j]:
                continue
            if ranks.get((sym[i], sym[j])) != r:
                continue
            # merge j into i
            sym[i] = sym[i] + sym[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prev[nxt[j]] = i
            version[i] += 1
            p = prev[i]
            if p >= 0 and alive[p]:
                version[p] += 1
                push(p)
            push(i)

        out = []
        i = 0
        while i >= 0:
            if alive[i]:
                out.append(sym[i])
            i = nxt[i]
        return out


def load_tokenizer(model_dir: str) -> Tokenizer:
    return Tokenizer(os.path.join(model_dir, "vocab.json"))
