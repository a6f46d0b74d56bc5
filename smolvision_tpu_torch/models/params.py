"""Weight loading: mmap'd safetensors -> stacked parameter dictionaries.

Port of the dense loaders of smolvision_tpu/models/params.py (Qwen3-ASR and
Qwen2.5-Omni) with the same layout, so the two packages can be compared
leaf by leaf:
  * per-layer weights are stacked along a leading layer axis [L, ...]
    (the model code takes views `w[i]`, no copies),
  * q/k/v are fused into `wqkv` (rows of q; k; v) and gate/up into
    `w_gate_up` ([gate; up]),
  * matmul weights take `param_dtype`; norms, biases and the conv stem
    stay f32; a tied lm_head is the embedding tensor itself,
  * Qwen2.5-Omni: a Conv1D stem, an encoder K projection without bias
    (zeros substituted), one `proj`, the learned audio bos / eos rows; its
    decoder has a QKV bias `bqkv` (f32, rows of q; k; v), no q/k norms and
    an untied lm_head.
  * an MoE decoder (Qwen3-Omni-30B-A3B): a layer is MoE when its router
    tensor exists; `router` [Lm, E, H] stays f32 whatever param_dtype is
    (a bf16 router flips expert choices), `e_gate` / `e_up` [Lm, E, MI, H]
    and `e_down` [Lm, E, H, MI] have one row per MoE layer, a mixed stack's
    `w_gate_up` / `w_down` one per dense layer (no zero-filled blocks), and
    the decoder's "moe_layers" holds one bool per layer
    (models/qwen3_decoder.layer_params).  Each expert is copied into device
    tensors allocated beforehand: the JAX loader's host `np.stack` of the
    experts would be 58 GB at the 30B.
`params_from_jax` turns the JAX loaders' pytrees (as numpy arrays) into
the same dictionaries; `quantize_decoder` makes the int8 (--q8) decoder,
its expert stacks one layer row at a time.  `load_decoder(...,
experts_on_host=True)` (--moe-offload) leaves the expert stacks out: they
stay in the checkpoint, models/moe_offload.HostExpertStore.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from smolvision_tpu_torch.config import ModelConfig
from smolvision_tpu_torch.device import resolve_device
from smolvision_tpu_torch.ops.quant import QuantW, quantize_weight

ENC_PREFIX = "thinker.audio_tower"
DEC_PREFIX = "thinker.model"

# leaves that take param_dtype; every other leaf is f32
ENC_WEIGHTS = frozenset({"wq", "wk", "wv", "wo", "fc1", "fc2", "conv_out_w",
                         "proj1_w", "proj2_w", "proj_w"})
DEC_WEIGHTS = frozenset({"wqkv", "wo", "w_gate_up", "w_down", "embed", "lm_head",
                         "e_gate", "e_up", "e_down"})

_ENC_LAYER_NAMES = {
    "attn_ln_w": "self_attn_layer_norm.weight",
    "attn_ln_b": "self_attn_layer_norm.bias",
    "wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
    "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
    "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
    "wo": "self_attn.out_proj.weight", "bo": "self_attn.out_proj.bias",
    "ffn_ln_w": "final_layer_norm.weight", "ffn_ln_b": "final_layer_norm.bias",
    "fc1": "fc1.weight", "fc1_b": "fc1.bias",
    "fc2": "fc2.weight", "fc2_b": "fc2.bias",
}
_ENC_TOP_NAMES = {
    "conv1_w": "conv2d1.weight", "conv1_b": "conv2d1.bias",
    "conv2_w": "conv2d2.weight", "conv2_b": "conv2d2.bias",
    "conv3_w": "conv2d3.weight", "conv3_b": "conv2d3.bias",
    "conv_out_w": "conv_out.weight",
    "ln_post_w": "ln_post.weight", "ln_post_b": "ln_post.bias",
    "proj1_w": "proj1.weight", "proj1_b": "proj1.bias",
    "proj2_w": "proj2.weight", "proj2_b": "proj2.bias",
}


def _put(t: torch.Tensor, dtype, device) -> torch.Tensor:
    # always a copy: the source may be a read-only view of the mmap
    return t.to(device=device, dtype=dtype, copy=True)


def _stack_parts(n: int, part, dtype, device) -> torch.Tensor:
    """part(0..n-1), host tensors of one shape made one at a time, copied
    into one [n, ...] tensor allocated on `device`: no stacked host copy,
    which at 7B widths would be gigabytes."""
    first = part(0)
    out = torch.empty((n, *first.shape), dtype=dtype, device=device)
    out[0].copy_(first)
    for i in range(1, n):
        out[i].copy_(part(i))
    return out


def _stack(reader, template: str, n: int, dtype, device) -> torch.Tensor:
    return _stack_parts(n, lambda i: reader.get(template.format(i=i)), dtype, device)


def _stack_experts(reader, template: str, layers, n_experts: int, dtype,
                   device) -> torch.Tensor:
    """[len(layers), E, ...]: the tensor `template` of every expert of each of
    `layers`, copied one expert at a time into a tensor allocated on
    `device` beforehand."""
    first = reader.get(template.format(i=layers[0], e=0))
    out = torch.empty((len(layers), n_experts, *first.shape), dtype=dtype, device=device)
    for j, i in enumerate(layers):
        for e in range(n_experts):
            out[j, e].copy_(reader.get(template.format(i=i, e=e)))
    return out


def load_qwen3_encoder(reader, cfg: ModelConfig, param_dtype=torch.bfloat16,
                       device=None) -> Dict[str, Any]:
    """The encoder's weights on `device` (the card unless the caller names
    the CPU; raises without a card)."""
    device = resolve_device(device)
    p = ENC_PREFIX
    L = cfg.enc_layers
    layers = {
        key: _stack(reader, p + ".layers.{i}." + name, L,
                    param_dtype if key in ENC_WEIGHTS else torch.float32, device)
        for key, name in _ENC_LAYER_NAMES.items()
    }
    out: Dict[str, Any] = {
        key: _put(reader.get(f"{p}.{name}"),
                  param_dtype if key in ENC_WEIGHTS else torch.float32, device)
        for key, name in _ENC_TOP_NAMES.items()
    }
    out["layers"] = layers
    return out


_Q25_ENC_TOP_NAMES = {
    "conv1_w": "conv1.weight", "conv1_b": "conv1.bias",
    "conv2_w": "conv2.weight", "conv2_b": "conv2.bias",
    "ln_post_w": "ln_post.weight", "ln_post_b": "ln_post.bias",
    "proj_w": "proj.weight", "proj_b": "proj.bias",
    "audio_bos_eos": "audio_bos_eos_token.weight",
}


def load_q25_encoder(reader, cfg: ModelConfig, param_dtype=torch.bfloat16,
                     device=None) -> Dict[str, Any]:
    """The Qwen2.5-Omni audio tower's weights on `device` (the card unless
    the caller names the CPU): the Qwen3 layer layout with a zero K bias
    (the checkpoint has none), the Conv1D stem, `proj` and the learned
    audio bos / eos rows (qwen25_omni_encoder.c)."""
    device = resolve_device(device)
    p = ENC_PREFIX
    L = cfg.enc_layers
    layers = {
        key: _stack(reader, p + ".layers.{i}." + name, L,
                    param_dtype if key in ENC_WEIGHTS else torch.float32, device)
        for key, name in _ENC_LAYER_NAMES.items() if key != "bk"
    }
    layers["bk"] = torch.zeros((L, cfg.enc_d_model), dtype=torch.float32, device=device)
    out: Dict[str, Any] = {
        key: _put(reader.get(f"{p}.{name}"),
                  param_dtype if key in ENC_WEIGHTS else torch.float32, device)
        for key, name in _Q25_ENC_TOP_NAMES.items()
    }
    out["layers"] = layers
    return out


def load_decoder(reader, cfg: ModelConfig, param_dtype=torch.bfloat16,
                 device=None, experts_on_host: bool = False) -> Dict[str, Any]:
    """Decoder weights on `device` (the card unless the caller names the
    CPU): Qwen3's (q/k norms, no QKV bias, tied or separate lm_head; dense,
    MoE or mixed) or Qwen2.5-Omni's (a QKV bias `bqkv`, no q/k norms, an
    untied lm_head).  experts_on_host: an MoE decoder's `e_gate`, `e_up`
    and `e_down` are None (the host-offload engine reads them from the
    checkpoint); the router and every other leaf are loaded."""
    device = resolve_device(device)
    p = DEC_PREFIX
    L = cfg.dec_layers
    f32 = torch.float32

    def _cat(names, dtype, kind="weight", rows=range(L)):
        """Each layer's (of `rows`) tensors `names` concatenated, stacked."""
        return _stack_parts(len(rows), lambda j: torch.cat(
            [reader.get(f"{p}.layers.{rows[j]}.{n}.{kind}") for n in names]), dtype, device)

    qkv = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")

    layers = {
        "input_ln": _stack(reader, p + ".layers.{i}.input_layernorm.weight", L, f32, device),
        "post_ln": _stack(reader, p + ".layers.{i}.post_attention_layernorm.weight", L,
                          f32, device),
        "wqkv": _cat(qkv, param_dtype),
        "wo": _stack(reader, p + ".layers.{i}.self_attn.o_proj.weight", L, param_dtype,
                     device),
    }
    # a layer is MoE iff its router exists (the JAX loader's per-layer probe)
    is_moe = tuple(cfg.is_moe and reader.has(f"{p}.layers.{i}.mlp.gate.weight")
                   for i in range(L))
    dense_rows = [i for i in range(L) if not is_moe[i]]
    moe_rows = [i for i in range(L) if is_moe[i]]
    if dense_rows:
        layers["w_gate_up"] = _cat(("mlp.gate_proj", "mlp.up_proj"), param_dtype,
                                   rows=dense_rows)
        layers["w_down"] = _cat(("mlp.down_proj",), param_dtype, rows=dense_rows)
    if moe_rows:
        layers["router"] = _cat(("mlp.gate",), f32, rows=moe_rows)
        for key, name in (("e_gate", "gate_proj"), ("e_up", "up_proj"),
                          ("e_down", "down_proj")):
            layers[key] = None if experts_on_host else _stack_experts(
                reader, p + ".layers.{i}.mlp.experts.{e}." + name + ".weight", moe_rows,
                cfg.num_experts, param_dtype, device)
    if cfg.dec_qkv_bias:
        layers["bqkv"] = _cat(qkv, f32, "bias")
    if cfg.dec_qk_norm:
        layers["q_norm"] = _stack(reader, p + ".layers.{i}.self_attn.q_norm.weight", L, f32,
                                  device)
        layers["k_norm"] = _stack(reader, p + ".layers.{i}.self_attn.k_norm.weight", L, f32,
                                  device)
    embed = _put(reader.get(p + ".embed_tokens.weight"), param_dtype, device)
    lm_head = embed if cfg.tied_embeddings else _put(
        reader.get("thinker.lm_head.weight"), param_dtype, device)
    out = {
        "embed": embed,
        "layers": layers,
        "final_norm": _put(reader.get(p + ".norm.weight"), f32, device),
        "lm_head": lm_head,
    }
    if moe_rows:
        out["moe_layers"] = is_moe
    return out


def _quantize_by_row(w: torch.Tensor) -> QuantW:
    """quantize_weight of a stack [L, ...], one leading row at a time into
    tensors allocated first: the f32 transient is one row's (the 30B's
    [16, 128, 768, 2048] expert stack whole would be 12.9 GB)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-1], dtype=torch.float32, device=w.device)
    for j in range(w.shape[0]):
        q[j], s[j] = quantize_weight(w[j])
    return QuantW(q, s)


def quantize_decoder(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8 quantization (--q8) of the decoder's matrices: wqkv, wo,
    w_gate_up, w_down, the MoE expert stacks e_gate / e_up / e_down (per
    output row, as every other matrix; the JAX quantize_decoder's default
    experts=True) and embed / lm_head (which stay ONE QuantW when tied: the
    embedding gather and the lm_head read the same int8 table).  Norms and
    the router stay f32, absent leaves (a dense decoder's experts, a
    uniform MoE stack's dense FFN, the host-offload engine's experts) stay
    absent; the KV cache is untouched.  See ops/quant.py for the numerics."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in ("wqkv", "wo", "w_gate_up", "w_down", "e_gate", "e_up", "e_down"):
        if layers.get(k) is not None:
            layers[k] = _quantize_by_row(layers[k])
    out["layers"] = layers
    out["embed"] = quantize_weight(params["embed"])
    tied = params["lm_head"] is params["embed"]
    out["lm_head"] = out["embed"] if tied else quantize_weight(params["lm_head"])
    return out


def _from_numpy(arr: np.ndarray, dtype, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy (jax hands out read-only views)
    if arr.dtype.name == "bfloat16":  # numpy's bf16 extension type
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(
            device=device, dtype=dtype)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _is_quant_pair(val) -> bool:
    """A (q, s) NamedTuple leaf pair: the JAX package's QuantW as numpy."""
    return isinstance(val, tuple) and getattr(val, "_fields", None) == ("q", "s")


def _quant_from_numpy(val, device) -> QuantW:
    return QuantW(torch.from_numpy(np.array(val.q)).to(device),
                  _from_numpy(val.s, torch.float32, device))


def _moe_rows_from_jax(dec_np: Mapping[str, Any]) -> Mapping[str, Any]:
    """The JAX decoder pytree with the port's MoE layout (see
    params_from_jax); a dense decoder's unchanged."""
    layers = dec_np["layers"]
    if layers.get("router") is None:
        return dec_np
    n = len(layers["router"])
    mask = layers.get("moe_mask")
    is_moe = tuple(bool(m) for m in np.asarray(mask)) if mask is not None else (True,) * n
    moe_rows = [i for i in range(n) if is_moe[i]]
    dense_rows = [i for i in range(n) if not is_moe[i]]
    out = {k: v for k, v in layers.items() if k != "moe_mask"}

    def rows(val, idx):   # a stack's rows; both leaves of a QuantW pair
        if val is None or not idx:
            return None
        if _is_quant_pair(val):
            return type(val)(np.asarray(val.q)[idx], np.asarray(val.s)[idx])
        return np.asarray(val)[idx]

    for k in ("router", "e_gate", "e_up", "e_down"):
        out[k] = rows(layers[k], moe_rows)
    for k in ("w_gate_up", "w_down"):
        out[k] = rows(layers[k], dense_rows)
    return dict(dec_np, layers=out, moe_layers=is_moe)


def params_from_jax(enc_np: Mapping[str, Any], dec_np: Mapping[str, Any], device=None,
                    dtype=torch.bfloat16):
    """The JAX loaders' (load_qwen3_encoder or load_q25_encoder, and
    load_decoder) pytrees, given as numpy arrays with stacked [L, ...]
    leaves, as the port's parameters: (encoder params, decoder params).
    Leaves the family has not (None entries: a dense decoder's MoE slots,
    Qwen3's `bqkv`, Qwen2.5-Omni's q/k norms) are dropped; a quantized leaf
    (the JAX package's QuantW under --q8, a (q, s) pair) becomes the port's
    QuantW; a tied lm_head stays one object with the embedding.  An MoE
    decoder's stacks keep the rows of their own layers (the JAX package's
    zero-filled blocks of a mixed stack and its `moe_mask` go; the mask
    becomes "moe_layers").  On `device`: the card unless the caller names
    the CPU."""
    device = resolve_device(device)
    dec_np = _moe_rows_from_jax(dec_np)

    def conv(tree, weights):
        out = {}
        for key, val in tree.items():
            if val is None:
                continue
            if isinstance(val, Mapping):
                out[key] = conv(val, weights)
            elif _is_quant_pair(val):
                out[key] = _quant_from_numpy(val, device)
            else:
                out[key] = _from_numpy(val, dtype if key in weights else torch.float32,
                                       device)
        return out

    def same(a, b):
        if _is_quant_pair(a) != _is_quant_pair(b):
            return False
        pairs = zip(a, b) if _is_quant_pair(a) else [(a, b)]
        return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in pairs)

    enc = conv(enc_np, ENC_WEIGHTS)
    lm_head = dec_np["lm_head"]
    tied = lm_head is dec_np["embed"] or same(lm_head, dec_np["embed"])
    dec = conv({k: v for k, v in dec_np.items() if k not in ("lm_head", "moe_layers")},
               DEC_WEIGHTS)
    if "moe_layers" in dec_np:
        dec["moe_layers"] = dec_np["moe_layers"]
    if tied:
        dec["lm_head"] = dec["embed"]
    elif _is_quant_pair(lm_head):
        dec["lm_head"] = _quant_from_numpy(lm_head, device)
    else:
        dec["lm_head"] = _from_numpy(lm_head, dtype, device)
    return enc, dec
