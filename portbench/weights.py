"""Seeded checkpoints drawn on the device: the tensors of a Qwen3-ASR
checkpoint (names, shapes, dtypes and value kinds of a real one) made from
the run's seed, never written to disk.

A checkpoint is a list of blocks.  A block is one generator call: the same
tensor of every layer (`dec.q_proj`: [L, H*D, H]).  Its values come from a generator
seeded by (seed, block name), so any block can be drawn again, alone and
bit for bit: the program's loader and the benchmark's reference each draw
what they need, and neither takes a tensor from the other.

`SeededCheckpoint` serves the blocks through the interface the program's
loader reads a safetensors directory by (`get`, `has`, `names`,
`get_optional`, `close`), each tensor a view of its block.  A few blocks
are kept (least recently used out), so a loader that walks a template over
its layers draws each block once.

The value kinds follow the program's own synthetic checkpoints: "rand" is
normal values times a std, "norm" is 1 + 0.02 x normal values, "const" a
fixed value.  Matrices (2-D and up, not norms) are drawn in bf16, the
dtype they are served in; vectors and norms in f32.

This module imports nothing of the program.
"""

from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

ENC = "thinker.audio_tower"
DEC = "thinker.model"


@dataclass(frozen=True)
class Block:
    """One generator call: `count` tensors `names[i]` of one `shape`."""
    key: str
    names: Tuple[str, ...]
    shape: Tuple[int, ...]
    kind: str          # "rand" | "norm" | "const"
    value: float       # std of "rand", the value of "const"
    dtype: torch.dtype


def _dtype(name: str, shape) -> torch.dtype:
    return torch.bfloat16 if len(shape) >= 2 and "norm" not in name else torch.float32


def blocks(cfg: dict) -> List[Block]:
    """The blocks of the checkpoint that configuration `cfg` (a
    portbench/configs file's "model" group) describes."""
    out: List[Block] = []

    def add(key, names, shape, kind="rand", value=0.05):
        names = tuple(names)
        out.append(Block(key, names, tuple(shape), kind, value, _dtype(names[0], shape)))

    def per_layer(key, template, n, shape, kind="rand", value=0.05):
        add(key, [template.format(i=i) for i in range(n)], shape, kind, value)

    e = cfg["encoder"]
    d, L, ffn, out_dim, ch = (e["d_model"], e["encoder_layers"], e["encoder_ffn_dim"],
                              e["output_dim"], e["downsample_hidden_size"])
    add("enc.conv2d1.weight", [f"{ENC}.conv2d1.weight"], (ch, 1, 3, 3), value=0.2)
    for name, shape in (("conv2d1.bias", (ch,)), ("conv2d2.weight", (ch, ch, 3, 3)),
                        ("conv2d2.bias", (ch,)), ("conv2d3.weight", (ch, ch, 3, 3)),
                        ("conv2d3.bias", (ch,)), ("conv_out.weight", (d, ch * 16)),
                        ("proj1.weight", (d, d)), ("proj1.bias", (d,)),
                        ("proj2.weight", (out_dim, d)), ("proj2.bias", (out_dim,))):
        add(f"enc.{name}", [f"{ENC}.{name}"], shape)
    lp = ENC + ".layers.{i}."
    per_layer("enc.attn_ln.w", lp + "self_attn_layer_norm.weight", L, (d,), "norm")
    per_layer("enc.attn_ln.b", lp + "self_attn_layer_norm.bias", L, (d,), value=0.02)
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        per_layer(f"enc.{proj}.w", lp + f"self_attn.{proj}.weight", L, (d, d))
        per_layer(f"enc.{proj}.b", lp + f"self_attn.{proj}.bias", L, (d,))
    per_layer("enc.ffn_ln.w", lp + "final_layer_norm.weight", L, (d,), "norm")
    per_layer("enc.ffn_ln.b", lp + "final_layer_norm.bias", L, (d,), value=0.02)
    per_layer("enc.fc1.w", lp + "fc1.weight", L, (ffn, d))
    per_layer("enc.fc1.b", lp + "fc1.bias", L, (ffn,))
    per_layer("enc.fc2.w", lp + "fc2.weight", L, (d, ffn))
    per_layer("enc.fc2.b", lp + "fc2.bias", L, (d,))
    add("enc.ln_post.weight", [f"{ENC}.ln_post.weight"], (d,), "const", 1.0)
    add("enc.ln_post.bias", [f"{ENC}.ln_post.bias"], (d,), "const", 0.0)

    t = cfg["text"]
    H, L, heads, kv, hd, V = (t["hidden_size"], t["num_hidden_layers"],
                              t["num_attention_heads"], t["num_key_value_heads"],
                              t["head_dim"], t["vocab_size"])
    add("dec.embed", [f"{DEC}.embed_tokens.weight"], (V, H), value=0.1)
    add("dec.norm", [f"{DEC}.norm.weight"], (H,), "const", 1.0)
    lp = DEC + ".layers.{i}."
    per_layer("dec.input_ln", lp + "input_layernorm.weight", L, (H,), "norm")
    per_layer("dec.post_ln", lp + "post_attention_layernorm.weight", L, (H,), "norm")
    per_layer("dec.q_proj", lp + "self_attn.q_proj.weight", L, (heads * hd, H))
    per_layer("dec.k_proj", lp + "self_attn.k_proj.weight", L, (kv * hd, H))
    per_layer("dec.v_proj", lp + "self_attn.v_proj.weight", L, (kv * hd, H))
    per_layer("dec.o_proj", lp + "self_attn.o_proj.weight", L, (H, heads * hd))
    per_layer("dec.q_norm", lp + "self_attn.q_norm.weight", L, (hd,), "norm")
    per_layer("dec.k_norm", lp + "self_attn.k_norm.weight", L, (hd,), "norm")
    inter = t["intermediate_size"]
    for proj, shape in (("gate_proj", (inter, H)), ("up_proj", (inter, H)),
                        ("down_proj", (H, inter))):
        per_layer(f"dec.{proj}", lp + f"mlp.{proj}.weight", L, shape)
    return out


def block_seed(seed: int, key: str) -> int:
    """The generator seed of block `key` under the run's `seed` (any whole
    number): 63 bits of a hash of both."""
    digest = hashlib.sha256(f"{int(seed)}/{key}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw(block: Block, seed: int, device) -> torch.Tensor:
    """The block's values [count, *shape], in its dtype, on `device`: one
    generator call."""
    device = torch.device(device)
    shape = (len(block.names), *block.shape)
    if block.kind == "const":
        return torch.full(shape, block.value, dtype=block.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, block.key))
    x = torch.randn(shape, generator=gen, dtype=block.dtype, device=device)
    if block.kind == "rand":
        return x.mul_(block.value)
    return x.mul_(0.02).add_(1.0)


class SeededCheckpoint:
    """The checkpoint of a configuration and a seed, drawn on `device` block
    by block as its tensors are asked for (the interface of a safetensors
    directory reader).  `keep` blocks stay drawn."""

    def __init__(self, cfg: dict, seed: int, device, keep: int = 6):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.keep = keep
        self.blocks = {b.key: b for b in blocks(cfg)}
        self._where: Dict[str, Tuple[str, int]] = {
            name: (b.key, j) for b in self.blocks.values() for j, name in enumerate(b.names)}
        self._drawn: "collections.OrderedDict[str, torch.Tensor]" = collections.OrderedDict()

    def block(self, key: str) -> torch.Tensor:
        t = self._drawn.get(key)
        if t is None:
            t = draw(self.blocks[key], self.seed, self.device)
            self._drawn[key] = t
            while len(self._drawn) > self.keep:
                self._drawn.popitem(last=False)
        else:
            self._drawn.move_to_end(key)
        return t

    def has(self, name: str) -> bool:
        return name in self._where

    def names(self):
        return self._where.keys()

    def get(self, name: str) -> torch.Tensor:
        where = self._where.get(name)
        if where is None:
            raise KeyError(f"weight not found: {name}")
        key, j = where
        return self.block(key)[j]

    def get_optional(self, name: str) -> Optional[torch.Tensor]:
        return self.get(name) if name in self._where else None

    def close(self) -> None:
        self._drawn.clear()
