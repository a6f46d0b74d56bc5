"""The MoE FFN of the Qwen3 decoder (Qwen3-Omni-30B-A3B): router, top-k and
the expert SwiGLU mix, in three formulations.

Port of `_moe_ffn` and its helpers in smolvision_tpu/models/qwen3_decoder.py
(reference semantics: moe_forward_single, qwen_asr_decoder.c:362-451):

  * the router runs in f32 whatever the weights' dtype (the JAX loader
    keeps it f32): scores, `topk`, a softmax over the top-k values and,
    with norm_topk_prob, their renormalisation (+ 1e-20).  In bf16 expert
    choices would flip;
  * `moe_apply_gathered` (T <= GATHER_MAX_T, every decode step): copies the
    chosen experts' blocks ([T, K, MI, H]) and runs each token through its
    own K experts;
  * `capacity_dispatch` (a longer block, E >= MOE_DISPATCH_MIN_EXPERTS):
    per-expert queues of C = min(T, ceil(T*K/E * MOE_CAPACITY_FACTOR))
    rows, each expert one [C, H] block; pad rows take no rank; it returns
    the count of valid (token, expert) pairs past capacity;
  * `moe_dense` (E < MOE_DISPATCH_MIN_EXPERTS, and the fallback whenever
    the dispatch drops): every expert over the whole block, weighted by
    the one-hot routing -- exact.

The choice for a block of T > GATHER_MAX_T rows depends on who runs it.
An eager forward (a host start: batched prefills, serving waves,
multistream rounds, the thinker's logits prefill) follows the JAX package
step for step: dispatch, read the drop count on the host, fall back to
dense.  A graph step's forward (a device start: the prefill graphs, the
batched decode step, the --spec verify; runtime/decode_graph.py) may never
read the device, and its control flow may not depend on the routing, so it
takes `moe_dense` directly: the same bytes (every expert read once) and
operations (E x T rows) as a dispatch that cannot drop (C = T), without the
scatter and the gather.  It runs the same formulation whether the step is
captured or run eagerly, so a graph's tokens equal its eager run's.  At
T <= GATHER_MAX_T both run the gather: a dense decode step would read all
E experts (58 GB at the 30B, ~17 ms a token).

Expert parallelism (parallel/mesh.py).  Under a "model" axis the expert
stacks are split over its ranks, rank r holding experts [e0, e0 + E/tp),
so the only form a rank can compute is the JAX package's `ep`
owner-compute: it runs its own experts over every row, the routing weights
of the others zeroed, and returns that partial sum, which the decoder sums
over the axis.  The router is whole on every rank, so the routing is the
same everywhere; the dispatch's drop count is its rank's, reduced with MAX
so that every rank falls back to dense together, as one device does.  The
JAX package's `ep` flag (owner-compute at tp 1 too) has no counterpart:
owner-compute is what a "model" axis group means here, and without one the
gather or the dispatch above is the same function at less cost.

The expert stacks may be int8 (--q8, the --spec draft: ops/quant.QuantW
with one scale per output row).  Every product of the three formulations
goes through `_emm`, which widens them (ops/quant.qbmm) and puts the scales
on the output axis: trailing for the gather's and the dense path's rows,
s[:, None, :] for the dispatch's per-expert queues (the JAX `_emm`).  The
gather copies the chosen blocks of both leaves (ops/quant.take).
"""

from __future__ import annotations

import math

import torch

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.ops.collectives import group_rank, pmax
from smolvision_tpu_torch.ops.common import bmm, silu
from smolvision_tpu_torch.ops.quant import QuantW, qbmm, reshape_out, take

MOE_DISPATCH_MIN_EXPERTS = 16
MOE_CAPACITY_FACTOR = 2.0
GATHER_MAX_T = 4


def router_scores(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """x [T, H] and the f32 router [E, H] -> f32 scores [T, E]."""
    return x.float() @ router.float().t()


def topk_weights(top_vals: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The chosen experts' weights from their scores [T, K]: a softmax, then
    norm_topk_prob's renormalisation."""
    top_w = torch.softmax(top_vals.float(), dim=-1)
    if cfg.norm_topk_prob:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    return top_w


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """x [T, H] f32 and the f32 router [E, H] -> (top_idx int64 [T, K],
    top_w f32 [T, K]): f32 scores, top-k, softmax over the top-k values,
    norm_topk_prob's renormalisation."""
    top_vals, top_idx = torch.topk(router_scores(x, router), cfg.num_experts_per_tok, dim=-1)
    return top_idx, topk_weights(top_vals, cfg)


def _emm(a: torch.Tensor, w) -> torch.Tensor:
    """a [N, M, H] @ w[N, O, H]^T -> f32 [N, M, O]; w a plain or an int8
    (QuantW, scales [N, O]) block stack."""
    if isinstance(w, QuantW):
        return qbmm(a, w)
    return bmm(a, w.transpose(1, 2))


def moe_apply_gathered(xc: torch.Tensor, g_w, u_w, d_w, top_w: torch.Tensor) -> torch.Tensor:
    """Per-token gathered expert SwiGLU mix: xc [T, H] in the weights' dtype,
    expert blocks g_w / u_w [T, K, MI, H] and d_w [T, K, H, MI] (plain or
    QuantW), router weights top_w [T, K] -> [T, H] f32.  Shared by the
    resident decode step and the host-offload engine
    (models/moe_offload.py), which passes the blocks it copied up."""
    T, K, MI, H = g_w.shape
    x3 = xc[:, None, :]
    gate = _emm(x3, reshape_out(g_w, T, K * MI)).reshape(T, K, MI)
    up = _emm(x3, reshape_out(u_w, T, K * MI)).reshape(T, K, MI)
    act = (silu(gate) * up).to(xc.dtype)
    down = _emm(act.reshape(T * K, 1, MI), reshape_out(d_w, T * K, H)).reshape(T, K, H)
    return torch.einsum("tk,tkh->th", top_w, down)


def _gathered(xc, lp, top_idx, top_w) -> torch.Tensor:
    """[E, A, B] stacks -> the chosen [T, K, A, B] blocks (a copy), mixed."""
    return moe_apply_gathered(xc, take(lp["e_gate"], top_idx), take(lp["e_up"], top_idx),
                              take(lp["e_down"], top_idx), top_w)


def capacity(T: int, K: int, E: int) -> int:
    """Rows of each expert's queue for a block of T tokens."""
    return min(T, int(math.ceil(T * K / E * MOE_CAPACITY_FACTOR)))


def capacity_dispatch(xc: torch.Tensor, lp, top_idx: torch.Tensor, top_w: torch.Tensor,
                      valid: torch.Tensor, e0: int = 0, n_experts=None):
    """Scatter tokens into per-expert queues [E, C, H] and run each expert
    over its one block.  valid [T] bool: pad rows get no rank (they take no
    capacity and receive nothing).  The stacks may be a rank's experts
    [e0, e0 + E) of n_experts (default E): queues and capacity are the whole
    routing's, only the rank's experts run.  Returns (out [T, H] f32,
    n_dropped: a 0-dim int64 tensor, the valid (token, expert) pairs of
    these experts past capacity)."""
    T, K = top_idx.shape
    E, _, H = lp["e_gate"].shape
    n_experts = n_experts or E
    C = capacity(T, K, n_experts)
    flat_e = top_idx.reshape(-1)                                     # [TK]
    oh = torch.nn.functional.one_hot(flat_e, n_experts) * \
        valid.repeat_interleave(K)[:, None].long()
    pos = (torch.cumsum(oh, dim=0) * oh).sum(dim=-1) - 1             # rank; -1 for pads
    mine = (flat_e >= e0) & (flat_e < e0 + E)
    keep = (pos >= 0) & (pos < C) & mine
    n_dropped = ((pos >= C) & mine).sum()
    slot = torch.where(keep, pos, C)                                 # C: the drop slot
    local_e = (flat_e - e0).clamp(0, E - 1)
    tok_of = torch.arange(T, device=xc.device).repeat_interleave(K)
    disp = xc.new_zeros((E, C + 1, H))
    disp[local_e, slot] = xc[tok_of]     # kept (expert, slot) pairs are unique
    disp = disp[:, :C]
    gate = _emm(disp, lp["e_gate"])                                  # [E, C, MI]
    up = _emm(disp, lp["e_up"])
    act = (silu(gate) * up).to(xc.dtype)
    down = _emm(act, lp["e_down"])                                   # [E, C, H]
    gathered = down[local_e, slot.clamp(max=C - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    out = (gathered.reshape(T, K, H) * top_w[..., None]).sum(dim=1)
    return out, n_dropped


def moe_dense(xc: torch.Tensor, lp, top_idx: torch.Tensor, top_w: torch.Tensor,
              e0: int = 0, n_experts=None) -> torch.Tensor:
    """Exact one-hot routing: every expert over the whole block [T, H] (a
    rank's experts [e0, e0 + E) of n_experts: their share of the sum)."""
    T = xc.shape[0]
    E, MI, H = lp["e_gate"].shape
    route_w = (torch.nn.functional.one_hot(top_idx, n_experts or E).float()
               * top_w[..., None]).sum(dim=1)[:, e0 : e0 + E]
    x3 = xc[None]
    gate = _emm(x3, reshape_out(lp["e_gate"], 1, E * MI)).reshape(T, E, MI)
    up = _emm(x3, reshape_out(lp["e_up"], 1, E * MI)).reshape(T, E, MI)
    act = (silu(gate) * up).to(xc.dtype)
    down = _emm(act.transpose(0, 1), lp["e_down"])                   # [E, T, H]
    return torch.einsum("te,eth->th", route_w, down)


def moe_ffn(x: torch.Tensor, lp, cfg: ModelConfig, valid=None,
            graph_safe: bool = False, group=None) -> torch.Tensor:
    """The MoE FFN of one layer: x [T, H] f32 -> [T, H] f32.  lp holds the
    layer's `router` [E, H] (f32) and `e_gate` / `e_up` [E, MI, H], `e_down`
    [E, H, MI] (plain, or QuantW: the activations then go in as bf16).  valid [T] bool marks the rows that may take expert
    capacity (None: all).  graph_safe: a graph step's forward, which reads
    nothing back and takes the dense path above GATHER_MAX_T rows (see the
    module notes); otherwise a dispatch that drops reads its count on the
    host and falls back to dense.  group: a "model" axis (module notes):
    the stacks are this rank's experts and the result its partial sum."""
    top_idx, top_w = route(x, lp["router"], cfg)
    xc = x.to(lp["e_gate"].dtype)
    T = x.shape[0]
    if T <= GATHER_MAX_T and group is None:
        return _gathered(xc, lp, top_idx, top_w)
    # this rank's experts [e0, e0 + E/tp) of the whole routing's
    share = (group_rank(group) * lp["e_gate"].shape[0], cfg.num_experts)
    if graph_safe or cfg.num_experts < MOE_DISPATCH_MIN_EXPERTS:
        return moe_dense(xc, lp, top_idx, top_w, *share)
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=x.device)
    out, n_dropped = capacity_dispatch(xc, lp, top_idx, top_w, valid, *share)
    if group is not None:   # every rank falls back together
        n_dropped = pmax(n_dropped.reshape(1), group)
    if int(n_dropped) > 0:   # the host read of an eager forward
        return moe_dense(xc, lp, top_idx, top_w, *share)
    return out
