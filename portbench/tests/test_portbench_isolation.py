"""In a fresh interpreter, importing the harness's entry, every entry and
metric reader, and the reference loads no module whose whole top-level
name is jax, jaxlib, flax or smolvision_tpu (the JAX package the port
copies), and the reference's modules load nothing of the port either.  A
run whose process holds such a module by the time it would print (a
reader that imported JAX, say) prints no result line."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_entry_loads_no_jax():
    tops = _loaded("import runpy; runpy.run_path('portbench/run.py', run_name='not_main')\n"
                   "import sys; sys.path.insert(0, '.')\n"
                   "from portbench import check, harness, devtrace, control")
    assert not tops & {"jax", "jaxlib", "flax", "smolvision_tpu"}


def test_every_entry_and_metric_reader_loads_no_jax():
    tops = _loaded("import glob, os, sys; sys.path.insert(0, '.')\n"
                   "from portbench import harness\n"
                   "for kind in ('entries', 'metrics'):\n"
                   "    for f in sorted(glob.glob(os.path.join('portbench', kind, '*.py'))):\n"
                   "        harness.load_module(kind, os.path.basename(f)[:-3])")
    assert "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "smolvision_tpu"}


def test_a_process_holding_jax_prints_no_result():
    code = ("import json, sys, types; sys.path.insert(0, '.')\n"
            "from portbench.tests.tiny import run_tiny\n"
            "from portbench import run\n"
            "out = run_tiny('asr06b.serve', seconds=0.5)\n"
            "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
            "print('rc', run.finish(out))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "rc 3"
    assert '"correct"' not in out.stdout
    assert "loaded jax" in out.stderr


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "from portbench.reference import qwen3_asr\n"
                   "from portbench import weights, traffic, costs")
    assert not tops & {"jax", "jaxlib", "flax", "smolvision_tpu", "smolvision_tpu_torch"}


def test_a_driven_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench.tests.tiny import run_tiny\n"
            "out = run_tiny('asr06b.serve', seconds=0.5)\n"
            "assert out['attempted'] > 0")
    tops = _loaded(code)
    assert "smolvision_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "smolvision_tpu"}
