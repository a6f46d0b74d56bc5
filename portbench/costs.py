"""The yardstick's arithmetic: the operations a request needs, counted from
its sizes (what the harness sent and got back), and the card's peaks.

Counted are the multiply-adds of every matrix product the published model
needs for the request, twice (a FLOP each for the multiply and the add):
the encoder's convolutions, projections and windowed attention over the
audio's valid tokens; the decoder's projections and causal attention over
each prompt row past the reused ones and each decoded token at its
context; the head once per generated token.  Padding, rows recomputed for
a bucket and steps past a request's end are not counted.
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, HBM3 read rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

HOP = 160


def _conv_w(w: int) -> int:
    return (w + 2 - 3) // 2 + 1


def encoder_flops(enc: dict, n_samples: int) -> float:
    """One clip (or stream span) of n_samples through the audio encoder."""
    d, L, ffn, out, ch = (enc["d_model"], enc["encoder_layers"], enc["encoder_ffn_dim"],
                          enc["output_dim"], enc["downsample_hidden_size"])
    chunk = 2 * enc["n_window"]
    frames = n_samples // HOP
    widths = [chunk] * (frames // chunk) + ([frames % chunk] if frames % chunk else [])
    flops, tokens = 0.0, 0
    for w in widths:
        w1, w2, w3 = _conv_w(w), _conv_w(_conv_w(w)), _conv_w(_conv_w(_conv_w(w)))
        flops += 2 * 9 * (ch * 64 * w1 + ch * ch * 32 * w2 + ch * ch * 16 * w3)
        flops += 2 * ch * 16 * d * w3
        tokens += w3
    win = _conv_w(_conv_w(_conv_w(chunk))) * (enc["n_window_infer"] // chunk)
    lens = [min(win, tokens - s) for s in range(0, tokens, win)]
    flops += L * (2 * tokens * (4 * d * d + 2 * d * ffn) + 4 * d * sum(n * n for n in lens))
    flops += 2 * tokens * (d * d + d * out)
    return float(flops)


def layer_weights(text: dict) -> int:
    """Multiply-adds per row of one decoder layer's projections."""
    H, heads, kv, hd = (text["hidden_size"], text["num_attention_heads"],
                        text["num_key_value_heads"], text["head_dim"])
    attn = H * (heads + 2 * kv) * hd + heads * hd * H
    return attn + 3 * H * text["intermediate_size"]


def decoder_flops(text: dict, prompt: int, generated: int, reused: int = 0) -> float:
    """Prefill of prompt rows reused.. and `generated` greedy tokens (the
    first from the prefill, each later one a step at its context)."""
    L, heads, hd = text["num_hidden_layers"], text["num_attention_heads"], text["head_dim"]
    W = layer_weights(text)
    head = 2 * text["vocab_size"] * text["hidden_size"]
    rows = range(reused, prompt)
    keys = sum(r + 1 for r in rows) + sum(prompt + j + 1 for j in range(max(generated - 1, 0)))
    n_rows = len(rows) + max(generated - 1, 0)
    return float(L * (2 * W * n_rows + 4 * heads * hd * keys) + head * generated)


def request_flops(conf_model: dict, items: Iterable[dict]) -> float:
    """Sum over work items {"samples": [encoded spans], "prompt", "generated",
    "reused"?} (portbench/entries/*.work)."""
    total = 0.0
    for it in items:
        total += sum(encoder_flops(conf_model["encoder"], n) for n in it["samples"])
        total += decoder_flops(conf_model["text"], it["prompt"], it["generated"],
                               it.get("reused", 0))
    return total


def head_bytes(text: dict) -> int:
    """Bytes one greedy-head call must read: the bf16 table [V, H]."""
    return 2 * text["vocab_size"] * text["hidden_size"]
