"""The control of the correctness check, kept at a size a CPU test run
holds: the cells' configuration at its full widths and depth (the
program's bf16 engine on the CPU), a few short requests.  The program's
widest served-token gap stays under the cell's limit; the control's (the
reference with every decoder matrix in symmetric per-row int8, read at
the same positions) goes over it.  On the card, at the cells' own sizes,
`python3 portbench/control.py` takes the readings the limits were set
from (PERF.md §2)."""

import argparse
import time

import pytest
import torch

from portbench import check, harness, traffic
from portbench import run as run_mod

CUT = {
    "asr06b.serve": {"clips_per_call": 4, "pool": 1, "slots": 4, "max_tokens": 12,
                     "check_clips": 4, "seconds": {"dist": "uniform", "min": 2.0, "max": 3.0}},
    "asr06b.stream": {"pool": 1, "seconds": {"dist": "fixed", "value": 6.0},
                      "stream_max_new_tokens": 12, "check_chunks": 3},
}


@pytest.mark.parametrize("cell", sorted(CUT))
def test_control_reads_over_the_limit_and_the_program_under_it(cell):
    torch.set_num_threads(8)
    entry = harness.find_cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), cell)
    mix = dict(traffic.load_mix(entry["traffic"]), **CUT[cell])
    conf = harness.load_json(harness.HERE, "configs", entry["config"] + ".json")
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 13, seconds=0.1, trace=0)
    out = run_mod.run_cell(args, device="cpu", t_start=time.perf_counter(), conf=conf, mix=mix,
                           control="int8", cell=entry)
    limit = check.limits(cell)["served_gap"]
    assert out["check"]["served_gap"] < limit < out["check"]["control_gap"], out["check"]
