"""Seeded random checkpoints in the reference layout (no real weights needed).

Port of tools/make_tiny_model.build for the dense Qwen3-ASR presets: the
exact tensor names, shapes and dtypes of a real checkpoint
(MODEL.md:285-330), a thinker-layout config.json and a synthetic byte-level
BPE vocab.json + merges.txt.  The random stream is drawn in the same order
as the tool's, so the same preset and seed give the same checkpoint bytes.

`tiny` is a seconds-fast model for tests; `0.6b` is the full Qwen3-ASR-0.6B
geometry (QWEN3_ASR_06B) with random values, ~1.9 GB in bf16.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from smolvision_tpu_torch.io.safetensors import write_safetensors
from smolvision_tpu_torch.text.tokenizer import bytes_to_unicode

PRESETS = {
    "tiny": dict(enc_d=64, enc_L=2, enc_heads=2, enc_ffn=128, enc_out=48,
                 conv_hidden=16, dec_h=48, dec_L=2, dec_heads=4, dec_kv=2,
                 head_dim=16, dec_inter=96, vocab=151936),
    "0.6b": dict(enc_d=896, enc_L=18, enc_heads=14, enc_ffn=3584, enc_out=1024,
                 conv_hidden=480, dec_h=1024, dec_L=28, dec_heads=16, dec_kv=8,
                 head_dim=128, dec_inter=3072, vocab=151936),
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


def build(preset: str, model_dir: str, seed: int = 0, dtype: str = "bf16",
          full_vocab: bool = False) -> str:
    """Write a `preset` checkpoint drawn from `seed` into model_dir."""
    p = PRESETS[preset]
    rng = np.random.default_rng(seed)
    os.makedirs(model_dir, exist_ok=True)
    out_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    t: Dict[str, torch.Tensor] = {}

    def rand(name, *shape, std=0.05):
        # matmul weights take the checkpoint dtype; vectors and norms stay f32
        a = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))
        t[name] = a.to(out_dtype) if a.ndim >= 2 and "norm" not in name else a

    def norm(name, n):
        t[name] = torch.from_numpy(
            np.ones(n, np.float32) + (rng.standard_normal((n,)) * 0.02).astype(np.float32))

    ep, dp = "thinker.audio_tower", "thinker.model"
    enc_d, enc_L, enc_ffn, enc_out = p["enc_d"], p["enc_L"], p["enc_ffn"], p["enc_out"]
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
            rand(f"{lp}.self_attn.{proj}.bias", enc_d)
        norm(f"{lp}.final_layer_norm.weight", enc_d)
        rand(f"{lp}.final_layer_norm.bias", enc_d, std=0.02)
        rand(f"{lp}.fc1.weight", enc_ffn, enc_d)
        rand(f"{lp}.fc1.bias", enc_ffn)
        rand(f"{lp}.fc2.weight", enc_d, enc_ffn)
        rand(f"{lp}.fc2.bias", enc_d)
    t[f"{ep}.ln_post.weight"] = torch.ones(enc_d)
    t[f"{ep}.ln_post.bias"] = torch.zeros(enc_d)

    dec_h, dec_L = p["dec_h"], p["dec_L"]
    heads, kv_heads, hd = p["dec_heads"], p["dec_kv"], p["head_dim"]
    inter, vocab = p["dec_inter"], p["vocab"]
    rand(f"{dp}.embed_tokens.weight", vocab, dec_h, std=0.1)
    t[f"{dp}.norm.weight"] = torch.ones(dec_h)
    for i in range(dec_L):
        lp = f"{dp}.layers.{i}"
        norm(f"{lp}.input_layernorm.weight", dec_h)
        norm(f"{lp}.post_attention_layernorm.weight", dec_h)
        rand(f"{lp}.self_attn.q_proj.weight", heads * hd, dec_h)
        rand(f"{lp}.self_attn.k_proj.weight", kv_heads * hd, dec_h)
        rand(f"{lp}.self_attn.v_proj.weight", kv_heads * hd, dec_h)
        rand(f"{lp}.self_attn.o_proj.weight", dec_h, heads * hd)
        norm(f"{lp}.self_attn.q_norm.weight", hd)
        norm(f"{lp}.self_attn.k_norm.weight", hd)
        rand(f"{lp}.mlp.gate_proj.weight", inter, dec_h)
        rand(f"{lp}.mlp.up_proj.weight", inter, dec_h)
        rand(f"{lp}.mlp.down_proj.weight", dec_h, inter)
    write_safetensors(os.path.join(model_dir, "model.safetensors"), t)

    config = {
        "model_type": f"qwen3_asr_{preset}",
        "thinker_config": {
            "audio_config": {
                "d_model": enc_d,
                "encoder_layers": enc_L,
                "encoder_attention_heads": p["enc_heads"],
                "encoder_ffn_dim": enc_ffn,
                "output_dim": enc_out,
                "num_mel_bins": 128,
                "max_source_positions": 1500,
                "n_window": 50,
                "n_window_infer": 800,
                "downsample_hidden_size": ch,
            },
            "text_config": {
                "hidden_size": dec_h,
                "num_hidden_layers": dec_L,
                "num_attention_heads": heads,
                "num_key_value_heads": kv_heads,
                "head_dim": hd,
                "intermediate_size": inter,
                "rms_norm_eps": 1e-6,
                "rope_theta": 1e6,
                "rope_scaling": {"mrope_section": [24, 20, 20]},
                "vocab_size": vocab,
                "tie_word_embeddings": True,
                "attention_bias": False,
                "qk_norm": True,
            },
            "audio_start_token_id": 151669,
            "audio_end_token_id": 151670,
            "audio_token_id": 151676,
        },
    }
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    make_vocab(model_dir, full=full_vocab)
    return model_dir
