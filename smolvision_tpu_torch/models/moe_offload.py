"""Host-offload MoE experts (--moe-offload): the expert weights stay in the
checkpoint's memory map and go to the card per layer, as they are needed.

Port of smolvision_tpu/models/moe_offload.py (reference semantics: the mmap
expert paging of qwen_asr_decoder.c:321-451, --moe-preload its madvise):

  * everything but the experts stays resident on the device (attention,
    norms, the f32 router, a mixed stack's dense FFN, embed / lm_head,
    the KV cache); `HostExpertStore` holds zero-copy views of every
    expert's three matrices, and a page is read from disk the first time
    its expert is copied (`preload` touches them all up front);
  * a decode step (T == 1) reads each MoE layer's f32 router scores on the
    host (one read per layer), takes the top-k there (`_topk_desc`), and
    copies only those experts: into a pinned staging buffer, then to a
    reused device buffer with an asynchronous copy;
  * a prefill streams each layer's whole stack, expert by expert, through
    the same staging buffers into a reused device [E, MI, H] stack;
  * the attention half, the expert mix and the FFN are the resident
    decoder's own functions (qwen3_decoder `_attn_block` against the
    engine's stacked cache, moe `moe_apply_gathered` and `moe_ffn` at a
    host start), so the two modes cannot drift apart.
The pinned buffers are two sets of K experts, used in turns: the host fills
one while the card copies from the other, and waits on a set's event before
it writes into it again.  Only they are pinned, never the expert set, which
would page in the whole checkpoint.  `stats` counts the router reads and
the bytes and host time of the copies and the router reads; `copy_events`,
when a list, gets each upload's kind ("gather" or "full") and CUDA events
(start, end), for the link rate.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.models import moe
from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
from smolvision_tpu_torch.models.params import DEC_PREFIX
from smolvision_tpu_torch.ops.common import rms_norm

_MATRICES = ("gate_proj", "up_proj", "down_proj")


class _Slot:
    """One pinned staging set (gate, up, down and the ids of n experts) and
    the event of the last upload that read it."""

    def __init__(self, shapes, n: int, dtype, pinned: bool):
        self.bufs = [torch.empty((n, *s), dtype=dtype, pin_memory=pinned) for s in shapes]
        self.ids = torch.empty(n, dtype=torch.int64, pin_memory=pinned)
        self.done: Optional[torch.cuda.Event] = None


class HostExpertStore:
    """Per-(layer, expert) zero-copy views of the expert tensors, and the
    buffers that carry them to `device`.

    Nothing is read at construction.  The views read the reader's memory
    maps, so the reader stays open while the store lives (the engine keeps
    both).  `is_moe[l]` comes from a tensor-name probe (the router's), so a
    mixed stack's dense layers have no rows here."""

    def __init__(self, reader, cfg: ModelConfig, device, prefix: str = DEC_PREFIX):
        L, E = cfg.dec_layers, cfg.num_experts
        self.cfg = cfg
        self.reader = reader
        self.device = torch.device(device)
        self.is_moe = [cfg.is_moe and reader.has(f"{prefix}.layers.{l}.mlp.gate.weight")
                       for l in range(L)]
        t = f"{prefix}.layers.{{l}}.mlp.experts.{{e}}.{{m}}.weight"
        self._views = [[[reader.get(t.format(l=l, e=e, m=m)) for e in range(E)]
                        for m in _MATRICES] if self.is_moe[l] else None for l in range(L)]
        first = next(rows for rows in self._views if rows is not None)
        self.dtype = first[0][0].dtype
        self._shapes = [tuple(rows[0].shape) for rows in first]   # (MI, H), (MI, H), (H, MI)
        self._slots: List[_Slot] = []
        self._turn = 0
        self._gathered: Optional[List[torch.Tensor]] = None
        self._full: Optional[List[torch.Tensor]] = None
        self.stats: Dict[str, Any] = {"router_reads": 0, "router_read_s": 0.0, "gathers": 0,
                                      "gather_bytes": 0, "gather_host_s": 0.0, "full_layers": 0,
                                      "full_bytes": 0, "full_host_s": 0.0}
        self.copy_events: Optional[list] = None

    def _slot(self) -> _Slot:
        """The next staging set, once the upload that last read it is done."""
        if not self._slots:
            n = self.cfg.num_experts_per_tok
            pinned = self.device.type == "cuda"
            self._slots = [_Slot(self._shapes, n, self.dtype, pinned) for _ in range(2)]
        slot = self._slots[self._turn]
        self._turn ^= 1
        if slot.done is not None:
            slot.done.synchronize()
        return slot

    def _stage_and_send(self, layer: int, experts, dev: List[torch.Tensor], at: int,
                        ids_to: Optional[torch.Tensor] = None) -> int:
        """Copy `experts` (at most K) of `layer` into a staging set, then send
        them to dev[m][at : at + len(experts)], and their ids to `ids_to` if
        given; returns the bytes of the experts sent."""
        slot = self._slot()
        n = len(experts)
        for m, views in enumerate(self._views[layer]):
            for i, e in enumerate(experts):
                slot.bufs[m][i].copy_(views[e])
        if ids_to is not None:
            slot.ids[:n] = torch.as_tensor(list(experts), dtype=torch.int64)
            ids_to.copy_(slot.ids[:n], non_blocking=True)
        cuda = self.device.type == "cuda"
        if cuda and self.copy_events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        for buf, d in zip(slot.bufs, dev):
            d[at : at + n].copy_(buf[:n], non_blocking=True)
        if cuda:
            slot.done = torch.cuda.Event(enable_timing=self.copy_events is not None)
            slot.done.record()
            if self.copy_events is not None:
                self.copy_events.append(("full" if ids_to is None else "gather", start,
                                         slot.done))
        return sum(buf[:n].numel() * buf.element_size() for buf in slot.bufs)

    def gather(self, layer: int, idx: np.ndarray):
        """idx [1, K] (the chosen experts of one token) -> (gate [1, K, MI, H],
        up [1, K, MI, H], down [1, K, H, MI], the ids [K] int64) on the
        device, the experts in the checkpoint's dtype: buffers the next
        gather reuses."""
        flat = [int(e) for e in np.asarray(idx).reshape(-1)]
        if self._gathered is None:
            self._gathered = [torch.empty((len(flat), *s), dtype=self.dtype, device=self.device)
                              for s in self._shapes]
            self._gathered_ids = torch.empty(len(flat), dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        self.stats["gather_bytes"] += self._stage_and_send(layer, flat, self._gathered, 0,
                                                           self._gathered_ids)
        self.stats["gather_host_s"] += time.perf_counter() - t0
        self.stats["gathers"] += 1
        return (*(b.reshape(*np.shape(idx), *b.shape[1:]) for b in self._gathered),
                self._gathered_ids)

    def layer_full(self, layer: int):
        """One layer's whole stacks (gate [E, MI, H], up, down [E, H, MI]) on
        the device, streamed K experts at a time through the staging sets
        into buffers the next call reuses (no stacked host copy)."""
        E, K = self.cfg.num_experts, self.cfg.num_experts_per_tok
        if self._full is None:
            self._full = [torch.empty((E, *s), dtype=self.dtype, device=self.device)
                          for s in self._shapes]
        t0 = time.perf_counter()
        for e0 in range(0, E, K):
            self.stats["full_bytes"] += self._stage_and_send(
                layer, range(e0, min(E, e0 + K)), self._full, e0)
        self.stats["full_host_s"] += time.perf_counter() - t0
        self.stats["full_layers"] += 1
        return tuple(self._full)

    def preload(self) -> int:
        """Touch every expert page (--moe-preload; the reference's madvise,
        qwen_asr_decoder.c:321-356).  Returns the bytes of the experts."""
        total = 0
        for rows in self._views:
            for views in rows or ():
                for v in views:
                    v.reshape(-1)[:: max(1, 4096 // v.element_size())].float().sum()
                    total += v.numel() * v.element_size()
        return total


def _topk_desc(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores, largest first, ties to the lower
    index (the selection of the JAX package's lax.top_k)."""
    return np.argsort(-scores, kind="stable")[:k].astype(np.int64)


def offload_forward(params: Dict[str, Any], store: HostExpertStore, cfg: ModelConfig,
                    embeds: torch.Tensor, start_pos: int, valid_len: int,
                    kv: torch.Tensor) -> torch.Tensor:
    """The layer stack over `embeds` [T, H] at cache row start_pos (a host
    int) with the experts from `store`; the decoder's params hold no expert
    stack.  Decode (T == 1): per MoE layer one host read of the router
    scores, the top-k on the host, those experts copied up and mixed
    (`moe_apply_gathered`).  Prefill: each MoE layer's stack streamed up
    and run through `moe_ffn` as an eager forward (dispatch, or dense).
    Dense layers of a mixed stack run their resident FFN.  Writes the
    block's K/V rows into the single-stream cache kv [L, 2, K, KH, D].
    Returns hidden [T, H] f32, before the final norm."""
    T = embeds.shape[0]
    at = dec_mod.block_positions(cfg, T, start_pos, valid_len, kv, embeds.device)
    valid = torch.arange(T, device=embeds.device) < valid_len
    h = embeds.float()
    for i, lp in enumerate(dec_mod.layer_params(params)):
        h = dec_mod._attn_block(lp, h, kv, i, cfg, *at)
        xn = rms_norm(h, lp["post_ln"], cfg.rms_norm_eps)
        if not store.is_moe[i]:
            h = h + dec_mod._dense_ffn(xn, lp)
        elif T == 1:
            scores = moe.router_scores(xn, lp["router"])                 # [1, E] f32
            t0 = time.perf_counter()
            idx = _topk_desc(scores[0].cpu().numpy(), cfg.num_experts_per_tok)
            store.stats["router_read_s"] += time.perf_counter() - t0
            store.stats["router_reads"] += 1
            g, u, d, ids = store.gather(i, idx[None])
            top_w = moe.topk_weights(scores[:, ids], cfg)
            h = h + moe.moe_apply_gathered(xn.to(store.dtype), g, u, d, top_w)
        else:
            g, u, d = store.layer_full(i)
            lp_full = {"router": lp["router"], "e_gate": g, "e_up": u, "e_down": d}
            h = h + moe.moe_ffn(xn, lp_full, cfg, valid)
    return h
