"""The device mesh on torch.distributed (port of smolvision_tpu/parallel/mesh.py).

The JAX package runs one controller and lets GSPMD insert the collectives
from NamedShardings.  PyTorch's idiom is SPMD: one process per rank, started
by the caller (torchrun style), every rank running the same host scheduler
over all rows.  A rank's tensors hold only its part:

  * the "data" axis splits batch rows: segments, serving slots, streams.
    Each data rank prefills and decodes its own rows; the values the host
    reads (first tokens, a decode chunk's tokens, the encoder's audio rows)
    are all-gathered over it, so every rank takes the same host decisions;
  * the "model" axis splits the decoder (Megatron layout): the fused QKV
    and gate/up rows, the wo / w_down columns, the experts and the
    vocabulary rows of embed / lm_head.  Its collectives
    (ops/collectives.py) are explicit and few: one all_reduce (SUM, f32)
    after wo, one after w_down or the experts' weighted sum, one for the
    vocabulary-sharded embedding lookup, and one (MAX over packed keys) for
    the vocabulary-sharded greedy head.  A MoE layer under this axis runs
    only its rank's experts (models/moe.py): expert parallelism is the
    "model" axis over an MoE decoder, not an option of its own.

A mesh is `make_mesh(...)` over a process group the caller has started:
`nccl` when each rank has a card of its own, `gloo` on the CPU or when
ranks share one card.  The backend and each rank's device are the caller's
choice; nothing here switches either when a collective fails.

Only the batched row-sharded paths (runtime/batch_segments.py,
runtime/serving.py, runtime/multistream.py's coordinator) are mesh-aware.
The single-stream paths are not tensor-parallel: a tp > 1 engine refuses
them with one line.  Under dp > 1 with tp 1 they run replicated, every rank
on its whole copy of the weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.ops.quant import QuantKV, QuantW

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's view of a (data, model) DeviceMesh: the axis sizes
    (`shape`, as the JAX Mesh's), its coordinate on each axis, the process
    group of each axis (None for an axis of size 1: no collective runs on
    it) and the rank's device."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        names = device_mesh.mesh_dim_names
        self.shape = {name: int(device_mesh.size(i)) for i, name in enumerate(names)}
        coord = device_mesh.get_coordinate()
        self.coord = {name: int(c) for name, c in zip(names, coord)}
        self._groups = {name: (device_mesh.get_group(name) if self.shape[name] > 1 else None)
                        for name in names}

    def group(self, axis: str):
        return self._groups[axis]

    def rows(self, n: int) -> slice:
        """This data rank's block of `n` batch rows (dp divides n)."""
        dp = self.shape[DATA_AXIS]
        if n % dp:
            raise ValueError(f"{n} rows do not split over a data axis of {dp}")
        per = n // dp
        return slice(self.coord[DATA_AXIS] * per, (self.coord[DATA_AXIS] + 1) * per)


def default_tp(n: int) -> int:
    """make_mesh's tp for n ranks: the largest of 4, 2 that divides n, else 1."""
    for cand in (4, 2):
        if n % cand == 0:
            return cand
    return 1


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              device=None) -> Mesh:
    """A (data, model) mesh over every rank of the started process group.
    tp defaults to the largest of 4, 2 that divides the world size (else 1).
    `device` is this rank's device (a card for `nccl`, the CPU or a card
    for `gloo`); it defaults to the CPU for `gloo`, and `nccl` needs it
    (which card is the caller's to say: ranks may share one)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("make_mesh needs a started process group "
                         "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans every rank: {n_devices} devices asked, world size {n}")
    tp = default_tp(n) if tp is None else tp
    if n % tp:
        raise ValueError(f"tp {tp} does not divide the world size {n}")
    if device is None:
        if dist.get_backend() == "nccl":
            raise ValueError("make_mesh over nccl needs this rank's card (device=)")
        device = "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        # before the mesh, which otherwise sets rank % cards as the current card
        torch.cuda.set_device(device)
    dm = init_device_mesh(device.type, (n // tp, tp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dm, device)


def decoder_shardings(cfg: ModelConfig, mesh: Optional[Mesh] = None):
    """Which axis of each decoder leaf splits over which mesh axis: a spec
    per leaf, one entry per dim (a mesh axis name or None), matching
    models/params.load_decoder's tree.  Megatron layout:
      wqkv / bqkv / w_gate_up: fused output rows split on "model" (the loader's
        fusion interleaved per rank first: interleave_decoder_for_tp),
      wo / w_down: input columns split (their partial products sum over "model"),
      e_gate / e_up / e_down: the expert axis split (expert parallelism),
      embed / lm_head: vocabulary rows split,
      norms, the router: replicated."""
    rep = ()
    row = (None, MODEL_AXIS, None)     # [L, out, in]: split out
    col = (None, None, MODEL_AXIS)     # [L, out, in]: split in
    experts = (None, MODEL_AXIS, None, None)
    layers = {
        "input_ln": rep, "post_ln": rep,
        "wqkv": row, "wo": col, "bqkv": (None, MODEL_AXIS),
        "q_norm": rep, "k_norm": rep,
        "w_gate_up": row, "w_down": col,
        "router": rep, "e_gate": experts, "e_up": experts, "e_down": experts,
    }
    return {"embed": (MODEL_AXIS, None), "layers": layers, "final_norm": rep,
            "lm_head": (MODEL_AXIS, None)}


def interleave_decoder_for_tp(params, cfg: ModelConfig, tp: int):
    """Permute the fused-output decoder weights for a tp-way "model" axis.

    The loader fuses QKV as [q; k; v] and the MLP as [gate; up]; splitting
    those axes directly would split q / kv (gate / up) unevenly over ranks,
    so their rows are permuted per rank:
        [q_0; k_0; v_0; q_1; k_1; v_1; ...]   resp.   [gate_0; up_0; ...]
    where x_r is heads (channels) chunk r.  Rank r's contiguous slice is then
    complete heads in the loader's own [q; k; v] (resp. [gate; up])
    order, which the decoder splits as it splits the whole fusion, with
    H/tp and KH/tp heads.  Returns a NEW params dict (wqkv / bqkv /
    w_gate_up replaced, by index_select); call it before shard_params.  tp
    must divide the q and kv heads and the intermediate."""
    if tp == 1:
        return params
    q_dim = cfg.dec_heads * cfg.dec_head_dim
    kv_dim = cfg.dec_kv_heads * cfg.dec_head_dim
    if cfg.dec_heads % tp or cfg.dec_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide heads ({cfg.dec_heads}/{cfg.dec_kv_heads})")

    def perm(sizes, device):
        offs = np.concatenate([[0], np.cumsum(sizes)])
        idx = []
        for r in range(tp):
            for j, s in enumerate(sizes):
                blk = s // tp
                start = int(offs[j]) + r * blk
                idx.extend(range(start, start + blk))
        return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)

    def take(w, idx):
        if isinstance(w, QuantW):
            return QuantW(w.q.index_select(1, idx), w.s.index_select(1, idx))
        return w.index_select(1, idx)

    layers = dict(params["layers"])
    qkv_perm = perm([q_dim, kv_dim, kv_dim], layers["wqkv"].q.device
                    if isinstance(layers["wqkv"], QuantW) else layers["wqkv"].device)
    layers["wqkv"] = take(layers["wqkv"], qkv_perm)
    if layers.get("bqkv") is not None:
        layers["bqkv"] = take(layers["bqkv"], qkv_perm)
    if layers.get("w_gate_up") is not None:
        I = layers["w_gate_up"].shape[1] // 2
        if I % tp:
            raise ValueError(f"tp={tp} must divide the intermediate ({I})")
        layers["w_gate_up"] = take(layers["w_gate_up"], perm([I, I], qkv_perm.device))
    return {**params, "layers": layers}


def _split_part(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of `t` under `spec` (a contiguous copy when split)."""
    for axis, name in enumerate(spec[: t.dim()]):
        if name is None:
            continue
        n = mesh.shape[name]
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split over {name} {n}")
        per = t.shape[axis] // n
        t = t.narrow(axis, mesh.coord[name] * per, per)
    return t.contiguous()


def shard_tensor(t, spec, mesh: Mesh):
    """This rank's part of a leaf (a tensor, a QuantW or a QuantKV): both
    leaves of a pair are cut on the same leading axes, the scales' spec the
    values' cut short."""
    if isinstance(t, (QuantW, QuantKV)):
        return type(t)(_split_part(t.q, spec, mesh), _split_part(t.s, spec[: t.s.dim()], mesh))
    return _split_part(t, spec, mesh)


def shard_params(params, template, mesh: Mesh):
    """Each leaf of `params` cut to this rank's part per `template` (a spec
    tree, decoder_shardings).  Walks the dicts by hand: params may hold
    None leaves, and keys the template has not (the host tuple
    "moe_layers") pass through; a tied embed / lm_head stays one tensor."""
    memo = {}

    def go(p, t):
        if p is None or t is None:
            return p
        if isinstance(p, dict):
            return {k: go(v, t.get(k)) for k, v in p.items()}
        key = id(p)
        if key not in memo:
            memo[key] = shard_tensor(p, t, mesh)
        return memo[key]

    return go(params, template)


def batched_kv_sharding(mesh: Optional[Mesh] = None, quant: bool = False):
    """Spec of the batched cache [L, 2, B, KH, K, D]: batch rows over
    "data", KV heads over "model"; quant=True gives the QuantKV pair of
    specs (its scales [L, 2, B, KH, K] cut on the same axes)."""
    full = (None, None, DATA_AXIS, MODEL_AXIS, None, None)
    return QuantKV(full, full[:5]) if quant else full


def batch_sharding(mesh: Optional[Mesh], rank: int):
    """Spec of activations [B, ...]: batch over "data", the rest whole."""
    return (DATA_AXIS,) + (None,) * (rank - 1)


def mesh_tp(mesh: Optional[Mesh]) -> int:
    """The tensor-parallel degree a mesh implies (1 for no mesh): the size
    of its "model" axis."""
    return 1 if mesh is None else int(mesh.shape.get(MODEL_AXIS, 1))


def mesh_dp(mesh: Optional[Mesh]) -> int:
    """The data-parallel degree a mesh implies (1 for no mesh)."""
    return 1 if mesh is None else int(mesh.shape.get(DATA_AXIS, 1))


def _check_divides(cfg: ModelConfig, params, tp: int) -> None:
    layers = params["layers"]
    sizes = {"query heads": cfg.dec_heads, "KV heads": cfg.dec_kv_heads,
             "vocabulary": params["embed"].shape[0]}
    if layers.get("w_gate_up") is not None:
        sizes["intermediate"] = layers["w_gate_up"].shape[1] // 2
    if layers.get("e_gate") is not None:
        sizes["experts"] = layers["e_gate"].shape[1]
    for what, n in sizes.items():
        if n % tp:
            raise ValueError(f"tp {tp} does not divide the decoder's {what} ({n})")


def _device_index(device):
    """(type, index) of a device, a card without an index the current one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return device.type, torch.cuda.current_device()
    return device.type, device.index or 0


def shard_engine(engine, mesh: Mesh):
    """Put a loaded Engine on `mesh` and turn on the mesh-aware batched paths
    (runtime/batch_segments.py, runtime/serving.py, runtime/multistream.py's
    coordinator): interleave the fused decoder weights for the mesh's tp,
    keep this rank's part of each leaf (decoder_shardings), keep the encoder
    whole on every rank, set engine.serving_mesh, and, for dp > 1 outside
    the q25 family, the encoder's sequence parallelism (the batched group
    encode splits its clips over "data"; windows are hard, so no clip's
    arithmetic changes).  Returns the engine.

    Refused, with one line, as in the JAX package (whose shard_params cannot
    place a QuantW, and whose batched forwards read the host-offloaded
    expert stacks): --q8 weights and --moe-offload.  The single-stream
    paths of a tp > 1 engine refuse to run (Engine._ensure_kv)."""
    if getattr(engine, "q8", False):
        raise ValueError("int8 decoder weights (--q8) do not shard over a mesh")
    if getattr(engine, "moe_offload", False):
        raise ValueError("--moe-offload decodes one stream at a time: it does not "
                         "run on a mesh")
    if _device_index(engine.device) != _device_index(mesh.device):
        raise ValueError(f"the engine is on {engine.device}, this rank's mesh device is "
                         f"{mesh.device}")
    tp = mesh_tp(mesh)
    if tp > 1:
        _check_divides(engine.cfg, engine.dec_params, tp)
        engine.dec_params = interleave_decoder_for_tp(engine.dec_params, engine.cfg, tp)
        engine.dec_params = shard_params(engine.dec_params, decoder_shardings(engine.cfg, mesh),
                                         mesh)
        engine.dec_params_draft = None   # --spec is a single-stream path
    engine.serving_mesh = mesh
    engine._enc_sp_mesh = mesh if mesh_dp(mesh) > 1 and engine.cfg.family != "q25" else None
    engine.reset_kv()
    return engine


# ---------------------------------------------------------------------------
# What the schedulers call
# ---------------------------------------------------------------------------


def model_group(engine):
    """The engine's "model" axis group: None off a mesh or at tp 1.  Under
    it the decoder holds this rank's part of every weight and of the
    caches' KV heads, and the MoE layers this rank's experts."""
    mesh = getattr(engine, "serving_mesh", None)
    return None if mesh is None else mesh.group(MODEL_AXIS)


def data_group(engine):
    """The engine's "data" axis group (None off a mesh or at dp 1)."""
    mesh = getattr(engine, "serving_mesh", None)
    return None if mesh is None else mesh.group(DATA_AXIS)
