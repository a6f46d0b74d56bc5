"""Tiny configurations and mixes for the CPU rehearsals of the cells: the
cells' own files with every size cut, so a cell runs end to end in
seconds on the CPU.  The decoder is wider and deeper than the program's
`tiny` preset (hidden 256, 4 layers): at hidden 48 a random tied head
repeats its input token whatever the cache holds, and a cache that is
never written goes unseen."""

from __future__ import annotations

import argparse
import copy
import time

from portbench import harness, traffic
from portbench import run as run_mod

TINY_ENC = dict(d_model=64, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=128,
                output_dim=256, downsample_hidden_size=16)
TINY_TEXT = dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
                 num_key_value_heads=4, head_dim=32, intermediate_size=512)

# each rehearsed cell: (configuration, mix, the mix cut to a few small
# requests)
TINY_CELLS = {
    "asr06b.serve": ("qwen3-asr-0.6b", "serve_queue64",
                     {"clips_per_call": 8, "pool": 2, "slots": 4, "max_tokens": 6,
                      "check_clips": 3}),
    "asr06b.stream": ("qwen3-asr-0.6b", "stream_live60s",
                      {"pool": 1, "seconds": {"dist": "fixed", "value": 12.0},
                       "stream_max_new_tokens": 5, "check_chunks": 4}),
}
CELLS = tuple(TINY_CELLS)
LIMITS = {"served_gap": 0.3}


def bench() -> dict:
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def tiny_conf(config: str) -> dict:
    conf = copy.deepcopy(harness.load_json(harness.HERE, "configs", config + ".json"))
    conf["name"] = "tiny-" + config
    conf["model"]["encoder"].update(TINY_ENC)
    conf["model"]["text"].update(TINY_TEXT)
    return conf


def run_tiny(cell: str, seed: int = 2 ** 31 + 5, seconds: float = 2.0, trace: int = 0,
             control=None) -> dict:
    """One CPU run of `cell` at the tiny sizes; the result object."""
    config, mix_name, cut = TINY_CELLS[cell]
    mix = dict(traffic.load_mix(mix_name), **cut)
    entry = {"name": cell, "config": config, "traffic": mix_name, "chips": 1}
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return run_mod.run_cell(args, device="cpu", t_start=time.perf_counter(),
                            conf=tiny_conf(config), mix=mix, control=control, cell=entry,
                            limits=LIMITS)
