"""Whether the timed path's outputs are correct: a sample of the requests
the window finished (drawn from the seed, the longest among them; the
entry says which) goes through the plain reference (portbench/reference/
qwen3_asr.py) on the same seeded weights and audio, and each served greedy
token is judged by how far its logit lies below the reference's best at
that position (the reference's forward over the prompt and the served
tokens).  The readings -- the widest gap (`served_gap`), the mean gap
(`served_gap_mean`) -- named in the cell's limits
(portbench/limits/<cell>.json) are compared with them, and every request
must have been answered.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench import traffic, weights
from portbench.harness import HERE, load_json
from portbench.reference.qwen3_asr import Reference, served_gaps


def limits(cell: str) -> Dict[str, float]:
    return load_json(HERE, "limits", cell + ".json")


def _stats(prefix: str, gaps) -> dict:
    """The widest gap, the mean gap and the share of tokens that are not
    the reference's best, over every judged token."""
    g = torch.cat(gaps).double()
    return {f"{prefix}_gap": float(g.max()), f"{prefix}_gap_mean": float(g.mean()),
            f"{prefix}_off_best": float((g > 0).double().mean())}


def readings(run, records, quant=None) -> dict:
    """The widest served-token gap over the sample (and, with `quant`, the
    widest gap of the token the quantized reference puts first at each of
    the same positions), with the count of cases and tokens judged and
    the cases that could not be (a cut or an audio block that differs)."""
    rng = np.random.default_rng(traffic.sub_seed(run.seed, "check"))
    ckpt = weights.SeededCheckpoint(run.conf["model"], run.seed, run.device, keep=16)
    ref = Reference(run.conf["model"], ckpt, run.device)
    cases = run.entry.cases(run, records, ref, rng)
    ref.free_encoder()
    bad = [c.tag for c in cases if c.audio is None or not c.served]
    good = [c for c in cases if c.audio is not None and c.served]
    out = {"cases": len(cases), "tokens": sum(len(c.served) for c in good), "bad": bad}
    if good:
        logits = ref.logits(good)
        out.update(_stats("served", [served_gaps(lg, c.served) for lg, c in zip(logits, good)]))
        if quant:
            qref = Reference(run.conf["model"], ckpt, run.device, quant=quant)
            qlogits = qref.logits(good)
            out.update(_stats("control", [served_gaps(lg, q.argmax(dim=-1).tolist())
                                          for lg, q in zip(logits, qlogits)]))
    ckpt.close()
    return out


def judge(run, records, quant=None) -> Tuple[bool, Dict[str, Tuple[float, float]], dict]:
    """(correct, {number: (value, limit)}, readings); `quant` adds the
    control's reading (portbench/control.py)."""
    lim = run.limits
    got = readings(run, records, quant)
    compared = {}
    ok = not got["bad"] and "served_gap" in got
    for name, limit in lim.items():
        value = got.get(name, float("inf"))
        compared[name] = (value, limit)
        ok = ok and value <= limit
    unanswered = sum(1 for rec in records for a in rec["answers"] if not a)
    compared["unanswered"] = (float(unanswered), 0.0)
    ok = ok and unanswered == 0
    if run.device != "cpu":
        torch.cuda.synchronize()
    return ok, compared, got
