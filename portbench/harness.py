"""One run of one cell: set-up, the measured window, the check, the line.

The harness finds everything by name: the cell in BENCHMARK.json, its
configuration in portbench/configs/<config>.json, its traffic mix in
portbench/traffic/<mix>.json, the mix's entry in portbench/entries/
<entry>.py, the cell's limits in portbench/limits/<cell>.json and each
per-layer metric's reader in portbench/metrics/<metric>.py.

The program under test is `smolvision_tpu_torch`.  The harness builds its
`Engine` on a small model directory (config.json and a vocab, written once
under build/portbench/) and hands it the seeded checkpoint
(portbench/weights.py) at the one place the engine opens its weights
(`runtime.engine.MultiSafetensors`), so no weight is written to disk.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from portbench import traffic, weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(ROOT, "build", "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "smolvision_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is one the port must not
    load (JAX, or the JAX package the port is a copy of)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program's model directory and engine
# ---------------------------------------------------------------------------

VOCAB_MERGES = [("t", "h"), ("th", "e"), ("Ġ", "a"), ("a", "n"), ("an", "d"),
                ("i", "n"), ("o", "n"), ("e", "r"), ("Ġ", "the")]


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def checkpoint_config(conf: dict) -> dict:
    """config.json of the configuration, in the thinker layout."""
    m = conf["model"]
    return {"model_type": m["model_type"],
            "thinker_config": {"audio_config": m["encoder"], "text_config": m["text"],
                               "audio_start_token_id": 151669, "audio_end_token_id": 151670,
                               "audio_token_id": 151676}}


def model_dir(conf: dict) -> str:
    """The configuration's model directory: config.json and a synthetic
    byte-level BPE vocab (all 256 bytes and a few merges), written once."""
    path = os.path.join(WORK, "models", conf["name"])
    files = {"config.json": json.dumps(checkpoint_config(conf), indent=1)}
    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    for a, b in VOCAB_MERGES:
        vocab.setdefault(a + b, len(vocab))
    files["vocab.json"] = json.dumps(vocab, ensure_ascii=False)
    files["merges.txt"] = "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in VOCAB_MERGES)
    os.makedirs(path, exist_ok=True)
    for name, text in files.items():
        full = os.path.join(path, name)
        if os.path.exists(full) and open(full, encoding="utf-8").read() == text:
            continue
        tmp = full + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, full)
    return path


def build_engine(conf: dict, seed: int, device: str):
    """The program's Engine of `conf` on the seeded checkpoint."""
    from smolvision_tpu_torch.runtime import engine as engine_mod

    ckpt = weights.SeededCheckpoint(conf["model"], seed, device)
    opened = engine_mod.MultiSafetensors
    engine_mod.MultiSafetensors = lambda _dir: ckpt
    try:
        eng = engine_mod.Engine(model_dir(conf), device=device)
    finally:
        engine_mod.MultiSafetensors = opened
    ckpt.close()
    eng.reader = None
    return eng


# ---------------------------------------------------------------------------
# counters of the program, summed over calls
# ---------------------------------------------------------------------------

PERF_SUMS = ("mel_ms", "encode_ms", "prefill_ms", "decode_ms", "batch_decode_ms",
             "batch_decode_steps", "decode_steps", "wasted_steps", "graph_captures",
             "prefill_captures", "prefill_replays", "encodes", "prefills", "reuse_prefills",
             "fresh_prefills", "delta_prefills", "total_ms")


@dataclass
class Totals:
    perf: Dict[str, float] = field(default_factory=lambda: {k: 0.0 for k in PERF_SUMS})
    serving_waves: List[dict] = field(default_factory=list)
    chunk_ms: List[float] = field(default_factory=list)

    def add(self, perf) -> None:
        perf.settle_mel()
        for k in PERF_SUMS:
            self.perf[k] += float(getattr(perf, k))
        self.serving_waves.extend(perf.serving_waves)


@dataclass
class Run:
    """What an entry works with, and what the metrics read."""
    cell: dict
    conf: dict
    mix: dict
    seed: int
    device: str
    engine: Any = None
    entry: Any = None
    pool: List[traffic.Request] = field(default_factory=list)
    totals: Totals = field(default_factory=Totals)
    records: List[dict] = field(default_factory=list)
    limits: Dict[str, float] = field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    audio_s: float = 0.0        # seconds of audio of the window's requests
    flops: float = 0.0          # operations they needed (portbench/costs.py)
    memory_peak: int = 0        # torch.cuda.max_memory_allocated() after the window
    sent: int = 0               # calls sent so far (the pool is cycled)
    trace: Optional[dict] = None
    launches: Dict[str, int] = field(default_factory=dict)
    rates: Dict[str, float] = field(default_factory=dict)   # audio s/s by window, traced runs

    def call(self, req: traffic.Request) -> dict:
        """One call of the entry, its counters added to the totals."""
        self.engine.perf.reset()
        rec = self.entry.call(self, req)
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.totals.add(self.engine.perf)
        return rec


def now() -> float:
    return time.perf_counter()


def free_engine(run: Run) -> None:
    """Drop the program's engine and its device memory."""
    run.engine = None
    gc.collect()
    if run.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
