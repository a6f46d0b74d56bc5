"""Seeded random checkpoints in the reference layout (no real weights needed).

Port of tools/make_tiny_model.build for the dense Qwen3-ASR, the MoE and
the Qwen2.5-Omni presets: the exact tensor names, shapes and dtypes of a real
checkpoint (MODEL.md:285-330; qwen25_omni_{encoder,decoder}.c), a
thinker-layout config.json and a synthetic byte-level BPE vocab.json +
merges.txt.  The random stream is drawn in the same order as the tool's,
so the same preset and seed give the same checkpoint bytes.  Tensors are
drawn and written one at a time (the header first, from their shapes), so
a checkpoint never sits in host memory whole.

`tiny`, `tiny-moe` (4 experts, top-2), `tiny-moe-mixed` (MoE in every
second layer: decoder_sparse_step 2) and `tiny-q25` are seconds-fast
models for tests; `0.6b` is the full Qwen3-ASR-0.6B geometry
(QWEN3_ASR_06B) with random values, ~1.9 GB in bf16; `q25-7b` the full
Qwen2.5-Omni-7B geometry (QWEN25_OMNI_7B), ~16.5 GB in bf16; `omni-30b`
the full Qwen3-Omni-30B-A3B geometry (QWEN3_OMNI_30B: 48 MoE layers of 128
experts, top-8), ~62 GB in bf16.  `omni-30b` is drawn by torch's
generator on the `device` build() is given (the card draws 62 GB in
seconds; numpy's generator would take minutes on one core), so no tool
preset matches it byte for byte; the other presets are drawn with numpy
in the tool's order.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from smolvision_tpu_torch.text.tokenizer import bytes_to_unicode

PRESETS = {
    "tiny": dict(enc_d=64, enc_L=2, enc_heads=2, enc_ffn=128, enc_out=48,
                 conv_hidden=16, dec_h=48, dec_L=2, dec_heads=4, dec_kv=2,
                 head_dim=16, dec_inter=96, vocab=151936),
    "0.6b": dict(enc_d=896, enc_L=18, enc_heads=14, enc_ffn=3584, enc_out=1024,
                 conv_hidden=480, dec_h=1024, dec_L=28, dec_heads=16, dec_kv=8,
                 head_dim=128, dec_inter=3072, vocab=151936),
    "tiny-q25": dict(enc_d=64, enc_L=2, enc_heads=2, enc_ffn=128, enc_out=48,
                     conv_hidden=0, dec_h=48, dec_L=2, dec_heads=4, dec_kv=2,
                     head_dim=16, dec_inter=96, vocab=152064, q25=True),
    # the full Qwen2.5-Omni-7B geometry (qwen25_omni.c:197-215)
    "q25-7b": dict(enc_d=1280, enc_L=32, enc_heads=20, enc_ffn=5120,
                   enc_out=3584, conv_hidden=0, dec_h=3584, dec_L=28,
                   dec_heads=28, dec_kv=4, head_dim=128, dec_inter=18944,
                   vocab=152064, q25=True),
    "tiny-moe": dict(enc_d=64, enc_L=2, enc_heads=2, enc_ffn=128, enc_out=48,
                     conv_hidden=16, dec_h=48, dec_L=2, dec_heads=4, dec_kv=2,
                     head_dim=16, dec_inter=96, vocab=151936,
                     moe=dict(num_experts=4, top_k=2, moe_inter=32)),
    # decoder_sparse_step 2: layers 1 and 3 are MoE, 0 and 2 dense (layer i
    # is MoE iff (i + 1) % sparse_step == 0)
    "tiny-moe-mixed": dict(enc_d=64, enc_L=2, enc_heads=2, enc_ffn=128,
                           enc_out=48, conv_hidden=16, dec_h=48, dec_L=4,
                           dec_heads=4, dec_kv=2, head_dim=16, dec_inter=96,
                           vocab=151936,
                           moe=dict(num_experts=4, top_k=2, moe_inter=32,
                                    sparse_step=2)),
    # the full Qwen3-Omni-30B-A3B geometry (QWEN3_OMNI_30B, qwen_asr.c:152-171)
    "omni-30b": dict(enc_d=1280, enc_L=32, enc_heads=20, enc_ffn=5120,
                     enc_out=2048, conv_hidden=480, dec_h=2048, dec_L=48,
                     dec_heads=32, dec_kv=4, head_dim=128, dec_inter=768,
                     vocab=151936, moe=dict(num_experts=128, top_k=8, moe_inter=768),
                     torch_draw=True),
}

_MERGES = [("t", "h"), ("th", "e"), ("Ġ", "a"), ("a", "n"), ("an", "d"),
           ("i", "n"), ("o", "n"), ("e", "r"), ("Ġ", "the"),
           ("l", "a"), ("la", "n"), ("lan", "g"), ("g", "u"),
           ("lang", "u"), ("langu", "a"), ("langua", "g"),
           ("languag", "e"), ("Ġ", "E"), ("ĠE", "n"), ("ĠEn", "g"),
           ("ĠEng", "l"), ("ĠEngl", "i"), ("ĠEngli", "s"),
           ("ĠEnglis", "h")]


def make_vocab(model_dir: str, full: bool = False) -> None:
    """Synthetic byte-level BPE vocab: all 256 bytes plus a few merges.

    `full` fills every regular id < 151643 with a unique piece "tok{id}", so
    any decoded id maps to distinct visible text and a transcript of random
    weights is a real token trace.  Special ids (>= 151643) stay absent, as
    in the real vocab.json."""
    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    next_id = 256
    for a, b in _MERGES:
        merged = a + b
        if merged not in vocab:
            vocab[merged] = next_id
            next_id += 1
        merges.append(f"{a} {b}")
    if full:
        for i in range(next_id, 151643):
            vocab[f"tok{i}"] = i
    with open(os.path.join(model_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(merges) + "\n")


# a tensor's recipe: (name, shape, kind, value): kind "rand" (normal values
# of std `value`), "norm" (1 + normal values of std 0.02) or "const" (all
# `value`); drawn in list order, which is the tool's order
Spec = Tuple[str, Tuple[int, ...], str, float]


def _draw_numpy(rng: np.random.Generator, shape, kind: str, value: float) -> np.ndarray:
    """f32 values of one recipe, drawn as the tool draws them."""
    if kind == "rand":
        return (rng.standard_normal(shape) * value).astype(np.float32)
    if kind == "norm":
        return np.ones(shape, np.float32) + (rng.standard_normal(shape) * 0.02).astype(
            np.float32)
    return np.full(shape, value, np.float32)


def _draw_torch(gen: torch.Generator, shape, kind: str, value: float) -> torch.Tensor:
    """f32 values of one recipe from torch's generator (on its device)."""
    if kind == "const":
        return torch.full(shape, value, device=gen.device)
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x * value if kind == "rand" else 1.0 + x * 0.02


def _specs(p: dict) -> List[Spec]:
    """Every tensor of a preset's checkpoint, in the tool's draw order."""
    out: List[Spec] = []

    def rand(name, *shape, std=0.05):
        out.append((name, shape, "rand", std))

    def norm(name, n):
        out.append((name, (n,), "norm", 0.0))

    def const(name, n, value):
        out.append((name, (n,), "const", value))

    q25 = p.get("q25", False)
    ep, dp = "thinker.audio_tower", "thinker.model"
    enc_d, enc_L, enc_ffn, enc_out = p["enc_d"], p["enc_L"], p["enc_ffn"], p["enc_out"]
    if q25:
        rand(f"{ep}.conv1.weight", enc_d, 128, 3)
        rand(f"{ep}.conv1.bias", enc_d)
        rand(f"{ep}.conv2.weight", enc_d, enc_d, 3)
        rand(f"{ep}.conv2.bias", enc_d)
        rand(f"{ep}.proj.weight", enc_out, enc_d)
        rand(f"{ep}.proj.bias", enc_out)
        rand(f"{ep}.audio_bos_eos_token.weight", 2, enc_out)
    else:
        ch = p["conv_hidden"]
        rand(f"{ep}.conv2d1.weight", ch, 1, 3, 3, std=0.2)
        rand(f"{ep}.conv2d1.bias", ch)
        rand(f"{ep}.conv2d2.weight", ch, ch, 3, 3)
        rand(f"{ep}.conv2d2.bias", ch)
        rand(f"{ep}.conv2d3.weight", ch, ch, 3, 3)
        rand(f"{ep}.conv2d3.bias", ch)
        rand(f"{ep}.conv_out.weight", enc_d, ch * 16)
        rand(f"{ep}.proj1.weight", enc_d, enc_d)
        rand(f"{ep}.proj1.bias", enc_d)
        rand(f"{ep}.proj2.weight", enc_out, enc_d)
        rand(f"{ep}.proj2.bias", enc_out)
    for i in range(enc_L):
        lp = f"{ep}.layers.{i}"
        norm(f"{lp}.self_attn_layer_norm.weight", enc_d)
        rand(f"{lp}.self_attn_layer_norm.bias", enc_d, std=0.02)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rand(f"{lp}.self_attn.{proj}.weight", enc_d, enc_d)
            if not (q25 and proj == "k_proj"):   # Qwen2.5-Omni: no K bias
                rand(f"{lp}.self_attn.{proj}.bias", enc_d)
        norm(f"{lp}.final_layer_norm.weight", enc_d)
        rand(f"{lp}.final_layer_norm.bias", enc_d, std=0.02)
        rand(f"{lp}.fc1.weight", enc_ffn, enc_d)
        rand(f"{lp}.fc1.bias", enc_ffn)
        rand(f"{lp}.fc2.weight", enc_d, enc_ffn)
        rand(f"{lp}.fc2.bias", enc_d)
    const(f"{ep}.ln_post.weight", enc_d, 1.0)
    const(f"{ep}.ln_post.bias", enc_d, 0.0)

    dec_h, dec_L = p["dec_h"], p["dec_L"]
    heads, kv_heads, hd = p["dec_heads"], p["dec_kv"], p["head_dim"]
    inter, vocab = p["dec_inter"], p["vocab"]
    rand(f"{dp}.embed_tokens.weight", vocab, dec_h, std=0.1)
    const(f"{dp}.norm.weight", dec_h, 1.0)
    if q25:
        rand("thinker.lm_head.weight", vocab, dec_h, std=0.1)
    for i in range(dec_L):
        lp = f"{dp}.layers.{i}"
        norm(f"{lp}.input_layernorm.weight", dec_h)
        norm(f"{lp}.post_attention_layernorm.weight", dec_h)
        rand(f"{lp}.self_attn.q_proj.weight", heads * hd, dec_h)
        rand(f"{lp}.self_attn.k_proj.weight", kv_heads * hd, dec_h)
        rand(f"{lp}.self_attn.v_proj.weight", kv_heads * hd, dec_h)
        rand(f"{lp}.self_attn.o_proj.weight", dec_h, heads * hd)
        if q25:
            rand(f"{lp}.self_attn.q_proj.bias", heads * hd)
            rand(f"{lp}.self_attn.k_proj.bias", kv_heads * hd)
            rand(f"{lp}.self_attn.v_proj.bias", kv_heads * hd)
        else:
            norm(f"{lp}.self_attn.q_norm.weight", hd)
            norm(f"{lp}.self_attn.k_norm.weight", hd)
        moe = p.get("moe")
        if moe and (i + 1) % moe.get("sparse_step", 1) == 0:
            E, mi = moe["num_experts"], moe["moe_inter"]
            rand(f"{lp}.mlp.gate.weight", E, dec_h)
            for e in range(E):
                rand(f"{lp}.mlp.experts.{e}.gate_proj.weight", mi, dec_h)
                rand(f"{lp}.mlp.experts.{e}.up_proj.weight", mi, dec_h)
                rand(f"{lp}.mlp.experts.{e}.down_proj.weight", dec_h, mi)
        else:
            rand(f"{lp}.mlp.gate_proj.weight", inter, dec_h)
            rand(f"{lp}.mlp.up_proj.weight", inter, dec_h)
            rand(f"{lp}.mlp.down_proj.weight", dec_h, inter)
    return out


def _write(path: str, specs: List[Spec], draw: Callable[[Tuple[int, ...], str, float], Any],
           out_dtype) -> None:
    """The safetensors file of `specs` (layout of io/safetensors.py's
    writer: header in list order, data back to back), each tensor drawn
    (`draw(shape, kind, value)`: numpy or torch f32 values), cast and written
    before the next is drawn.  Matmul weights (2-D and up, not norms) take
    out_dtype; vectors and norms stay f32."""
    dtypes = [out_dtype if len(shape) >= 2 and "norm" not in name else torch.float32
              for name, shape, _, _ in specs]
    header, offset = {}, 0
    for (name, shape, _, _), dt in zip(specs, dtypes):
        nbytes = int(np.prod(shape)) * (2 if dt == torch.bfloat16 else 4)
        header[name] = {"dtype": "BF16" if dt == torch.bfloat16 else "F32",
                        "shape": list(shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for (_, shape, kind, value), dt in zip(specs, dtypes):
            t = torch.as_tensor(draw(shape, kind, value)).to(dt).cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy())
            del t


def build(preset: str, model_dir: str, seed: int = 0, dtype: str = "bf16",
          full_vocab: bool = False, device: str = "cpu", dec_layers: int = None) -> str:
    """Write a `preset` checkpoint drawn from `seed` into model_dir; a
    `torch_draw` preset is drawn on `device`.  dec_layers cuts the decoder's
    depth (its first layers, and config.json's num_hidden_layers) where a
    host cannot take the whole checkpoint."""
    p = PRESETS[preset] if dec_layers is None else dict(PRESETS[preset], dec_L=dec_layers)
    q25 = p.get("q25", False)
    moe = p.get("moe")
    os.makedirs(model_dir, exist_ok=True)
    if p.get("torch_draw"):
        gen = torch.Generator(device=device).manual_seed(seed)
        draw = lambda shape, kind, value: _draw_torch(gen, shape, kind, value)  # noqa: E731
    else:
        rng = np.random.default_rng(seed)
        draw = lambda shape, kind, value: _draw_numpy(rng, shape, kind, value)  # noqa: E731
    _write(os.path.join(model_dir, "model.safetensors"), _specs(p), draw,
           torch.bfloat16 if dtype == "bf16" else torch.float32)
    config = {
        "model_type": "qwen2_5_omni" if q25 else f"qwen3_asr_{preset}",
        "thinker_config": {
            "audio_config": {
                "d_model": p["enc_d"],
                "encoder_layers": p["enc_L"],
                "encoder_attention_heads": p["enc_heads"],
                "encoder_ffn_dim": p["enc_ffn"],
                "output_dim": p["enc_out"],
                "num_mel_bins": 128,
                "max_source_positions": 1500,
                "n_window": 50,
                "n_window_infer": 800,
                "downsample_hidden_size": p["conv_hidden"],
            },
            "text_config": {
                "hidden_size": p["dec_h"],
                "num_hidden_layers": p["dec_L"],
                "num_attention_heads": p["dec_heads"],
                "num_key_value_heads": p["dec_kv"],
                "head_dim": p["head_dim"],
                "intermediate_size": p["dec_inter"],
                "rms_norm_eps": 1e-6,
                "rope_theta": 1e6,
                "rope_scaling": {"mrope_section": [24, 20, 20]},
                "vocab_size": p["vocab"],
                "tie_word_embeddings": not q25,
                "attention_bias": bool(q25),
                "qk_norm": not q25,
                **({"num_experts": moe["num_experts"],
                    "num_experts_per_tok": moe["top_k"],
                    "moe_intermediate_size": moe["moe_inter"],
                    "norm_topk_prob": True,
                    "decoder_sparse_step": moe.get("sparse_step", 1)}
                   if moe else {}),
            },
            "audio_start_token_id": 151647 if q25 else 151669,
            "audio_end_token_id": 151648 if q25 else 151670,
            "audio_token_id": 151646 if q25 else 151676,
        },
    }
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    make_vocab(model_dir, full=full_vocab)
    return model_dir
