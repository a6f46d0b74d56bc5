"""The one traffic generator: reads a mix's parameters (portbench/traffic/
<mix>.json) and makes the requests of a run from its seed.

A mix names the entry that sends its requests (portbench/entries/
<entry>.py) and the sizes of its requests.  Every seed gets the same
multiset of sizes: lengths are fixed quantiles of the mix's distribution,
and the seed only orders them and makes the audio.  So two seeds give the
same work and differ in content, and the spread between runs is the
system's, not the traffic's.

Sizes (`seconds`): {"dist": "fixed", "value": s}, {"dist": "uniform",
"min": a, "max": b} or {"dist": "lognormal", "median": m, "sigma": s,
"min": a, "max": b}; `count` sizes make one set.

Audio is `speech_like`: AM-modulated tones with a pause every 3 s and a
little noise (a copy of the program's smoke-test clip generator), its
noise drawn from the request's own seed.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List

import numpy as np

SAMPLE_RATE = 16000
HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed derived from the run's seed and `parts`."""
    digest = hashlib.sha256("/".join(str(p) for p in (int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def speech_like(seconds: float, seed: int) -> np.ndarray:
    """AM-modulated tones with pauses and a little noise, float32 at 16 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SAMPLE_RATE * seconds)) / SAMPLE_RATE
    sig = (0.30 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
           + 0.15 * np.sin(2 * np.pi * 880 * t) * (t % 1.0 < 0.4)
           + 0.01 * rng.standard_normal(len(t)))
    for s0 in np.arange(1.4, seconds, 3.0):  # a pause every 3 s
        sig[int(s0 * SAMPLE_RATE): int((s0 + 0.3) * SAMPLE_RATE)] *= 0.02
    return sig.astype(np.float32)


def sizes(spec: dict, count: int) -> List[float]:
    """`count` sizes at the quantiles (i + 0.5) / count of `spec`, rounded
    to 10 ms, in ascending order."""
    qs = [(i + 0.5) / count for i in range(count)]
    dist = spec["dist"]
    if dist == "fixed":
        vals = [float(spec["value"])] * count
    elif dist == "uniform":
        vals = [spec["min"] + q * (spec["max"] - spec["min"]) for q in qs]
    elif dist == "lognormal":
        nd = NormalDist()
        vals = [min(max(spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(q)), spec["min"]),
                    spec["max"]) for q in qs]
    else:
        raise ValueError(f"unknown size distribution {dist!r}")
    return [round(v, 2) for v in vals]


@dataclass
class Request:
    """One call of the entry: its clips (one for a recording or a single
    clip, several for a queue), their seconds, and its index."""
    index: int
    clips: List[np.ndarray] = field(default_factory=list)

    @property
    def audio_s(self) -> float:
        return sum(len(c) for c in self.clips) / SAMPLE_RATE


def requests(mix: dict, seed: int) -> List[Request]:
    """The run's pool of `pool` calls.  A call of several clips (a queue)
    holds the sizes of one set (`sizes` of `clips_per_call`), in an order
    drawn from the seed; calls of one clip each take one size of a set of
    `pool`, dealt in an order drawn from the seed.  Each clip's audio comes
    from its own seed.  The harness cycles through the pool."""
    per_call, pool = mix.get("clips_per_call", 1), mix["pool"]
    rng = np.random.default_rng(sub_seed(seed, "order"))
    if per_call > 1:
        calls = [[sizes(mix["seconds"], per_call)[i] for i in rng.permutation(per_call)]
                 for _ in range(pool)]
    else:
        one = sizes(mix["seconds"], pool)
        calls = [[one[i]] for i in rng.permutation(pool)]
    return [Request(k, [speech_like(s, sub_seed(seed, "clip", k, j)) for j, s in enumerate(secs)])
            for k, secs in enumerate(calls)]
