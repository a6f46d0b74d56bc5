"""The harness finds a configuration, a traffic mix and a per-layer metric
by name: added as new files beside the others (in a copy of the
benchmark), a new cell runs with no edit to any file that was there."""

import json
import os
import shutil
import subprocess
import sys

from portbench.tests.tiny import TINY_ENC, TINY_TEXT

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "smolvision_tpu_torch"), tmp_path / "smolvision_tpu_torch")
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (tmp_path / "portbench").rglob("*") if x.is_file())}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pb = tmp_path / "portbench"
    conf = json.load(open(pb / "configs" / "qwen3-asr-0.6b.json"))
    conf["name"] = "tiny-asr"
    conf["model"]["encoder"].update(TINY_ENC)
    conf["model"]["text"].update(TINY_TEXT)
    (pb / "configs" / "tiny-asr.json").write_text(json.dumps(conf))
    mix = json.load(open(pb / "traffic" / "serve_queue64.json"))
    mix.update(clips_per_call=4, pool=1, slots=2, max_tokens=4, check_clips=2)
    (pb / "traffic" / "tiny_queue.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny.serve.json").write_text(json.dumps({"served_gap": 1e9}))
    (pb / "metrics" / "clips_per_call.py").write_text(
        "def read(run):\n    return len(run.records[0]['clips'])\n")
    bench["workloads"].append({"name": "tiny.serve", "config": "tiny-asr",
                               "traffic": "tiny_queue", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "clips_per_call", "unit": "clips", "better": "higher",
                               "source": "program_counter", "layer": "schedulers",
                               "moves": "audio_s_per_s", "workloads": ["tiny.serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import argparse, json, sys, time; sys.path.insert(0, '.')\n"
            "from portbench import run\n"
            "a = argparse.Namespace(workload='tiny.serve', seed=5, seconds=0.5, trace=1)\n"
            "print(json.dumps(run.run_cell(a, device='cpu', t_start=time.perf_counter())))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["clips_per_call"]["value"] == 4.0
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
