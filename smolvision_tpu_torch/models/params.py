"""Weight loading: mmap'd safetensors -> stacked parameter dictionaries.

Port of the dense loaders of smolvision_tpu/models/params.py with the same
layout, so the two packages can be compared leaf by leaf:
  * per-layer weights are stacked along a leading layer axis [L, ...]
    (the model code takes views `w[i]`, no copies),
  * q/k/v are fused into `wqkv` (rows of q; k; v) and gate/up into
    `w_gate_up` ([gate; up]),
  * matmul weights take `param_dtype`; norms, biases and the conv stem
    stay f32; a tied lm_head is the embedding tensor itself.
`params_from_jax` turns the JAX loaders' pytrees (as numpy arrays) into
the same dictionaries; `quantize_decoder` makes the int8 (--q8) decoder.
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
                         "proj1_w", "proj2_w"})
DEC_WEIGHTS = frozenset({"wqkv", "wo", "w_gate_up", "w_down", "embed", "lm_head"})

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


def _stack(reader, template: str, n: int, dtype, device) -> torch.Tensor:
    return _put(torch.stack([reader.get(template.format(i=i)) for i in range(n)]),
                dtype, device)


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


def load_decoder(reader, cfg: ModelConfig, param_dtype=torch.bfloat16,
                 device=None) -> Dict[str, Any]:
    """Dense Qwen3 decoder weights (q/k norms, no QKV bias, tied or separate
    lm_head) on `device` (the card unless the caller names the CPU).  MoE
    and biased-QKV checkpoints are not ported yet."""
    device = resolve_device(device)
    if cfg.is_moe or cfg.dec_qkv_bias or not cfg.dec_qk_norm:
        raise ValueError(f"{cfg.name}: only dense Qwen3 decoders are ported "
                         "to smolvision_tpu_torch")
    p = DEC_PREFIX
    L = cfg.dec_layers
    f32 = torch.float32

    def _cat(i, names):
        return torch.cat([reader.get(f"{p}.layers.{i}.{n}.weight") for n in names])

    layers = {
        "input_ln": _stack(reader, p + ".layers.{i}.input_layernorm.weight", L, f32, device),
        "post_ln": _stack(reader, p + ".layers.{i}.post_attention_layernorm.weight", L,
                          f32, device),
        "wqkv": _put(torch.stack([
            _cat(i, ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"))
            for i in range(L)]), param_dtype, device),
        "wo": _stack(reader, p + ".layers.{i}.self_attn.o_proj.weight", L, param_dtype,
                     device),
        "q_norm": _stack(reader, p + ".layers.{i}.self_attn.q_norm.weight", L, f32, device),
        "k_norm": _stack(reader, p + ".layers.{i}.self_attn.k_norm.weight", L, f32, device),
        "w_gate_up": _put(torch.stack([
            _cat(i, ("mlp.gate_proj", "mlp.up_proj")) for i in range(L)]),
            param_dtype, device),
        "w_down": _stack(reader, p + ".layers.{i}.mlp.down_proj.weight", L, param_dtype,
                         device),
    }
    embed = _put(reader.get(p + ".embed_tokens.weight"), param_dtype, device)
    lm_head = embed if cfg.tied_embeddings else _put(
        reader.get("thinker.lm_head.weight"), param_dtype, device)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": _put(reader.get(p + ".norm.weight"), f32, device),
        "lm_head": lm_head,
    }


def quantize_decoder(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8 quantization (--q8) of the dense decoder's matrices: wqkv, wo,
    w_gate_up, w_down and embed / lm_head, which stay ONE QuantW when tied
    (the embedding gather and the lm_head read the same int8 table).  Norms
    stay f32; the KV cache is untouched.  See ops/quant.py for the numerics."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in ("wqkv", "wo", "w_gate_up", "w_down"):
        layers[k] = quantize_weight(layers[k])
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


def params_from_jax(enc_np: Mapping[str, Any], dec_np: Mapping[str, Any], device=None,
                    dtype=torch.bfloat16):
    """The JAX loaders' (load_qwen3_encoder, load_decoder) pytrees, given as
    numpy arrays with stacked [L, ...] leaves, as the port's parameters:
    (encoder params, decoder params).  Leaves the dense port does not use
    (None entries, MoE/bias slots) are dropped; a quantized leaf (the JAX
    package's QuantW under --q8, a (q, s) pair) becomes the port's QuantW;
    a tied lm_head stays one object with the embedding.  On `device`: the
    card unless the caller names the CPU."""
    device = resolve_device(device)

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
    dec = conv({k: v for k, v in dec_np.items() if k != "lm_head"}, DEC_WEIGHTS)
    if tied:
        dec["lm_head"] = dec["embed"]
    elif _is_quant_pair(lm_head):
        dec["lm_head"] = _quant_from_numpy(lm_head, device)
    else:
        dec["lm_head"] = _from_numpy(lm_head, dtype, device)
    return enc, dec
