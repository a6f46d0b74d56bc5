"""The port stands alone: smolvision_tpu_torch and chip_smoke.py import no jax
and nothing of smolvision_tpu, and the entry points never fall back to the
CPU on their own.

tests/conftest.py imports jax into every test process, so the import check
runs in a fresh subprocess.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "smolvision_tpu_torch"


def _run(code, env_extra=None, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "SMOLVISION_PLATFORM"}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=cwd)


def _is_jax_package(mod: str) -> bool:
    return (mod in ("jax", "jaxlib", "smolvision_tpu")
            or mod.startswith(("jax.", "jaxlib.", "smolvision_tpu.")))


def test_port_imports_no_jax():
    r = _run(
        "import sys\n"
        "import smolvision_tpu_torch, smolvision_tpu_torch.cli\n"
        "import smolvision_tpu_torch.runtime.engine, smolvision_tpu_torch.kernels.flash_attention\n"
        "import smolvision_tpu_torch.kernels.build, smolvision_tpu_torch.models.synthetic\n"
        "import smolvision_tpu_torch.runtime.segment, smolvision_tpu_torch.runtime.batch_segments\n"
        "import smolvision_tpu_torch.runtime.serving, smolvision_tpu_torch.parallel.batch\n"
        "import smolvision_tpu_torch.ops.quant, smolvision_tpu_torch.kernels.argmax_matvec\n"
        "import smolvision_tpu_torch.kernels.probes\n"
        "import smolvision_tpu_torch.runtime.stream, smolvision_tpu_torch.io.live\n"
        "import smolvision_tpu_torch.runtime.multistream\n"
        "import smolvision_tpu_torch.runtime.sampling, smolvision_tpu_torch.models.q25_encoder\n"
        "import smolvision_tpu_torch.models.moe\n"
        "import smolvision_tpu_torch.models.moe_offload\n"
        "import smolvision_tpu_torch.parallel.mesh, smolvision_tpu_torch.ops.collectives\n"
        "import smolvision_tpu_torch.utils.native\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'smolvision_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'smolvision_tpu.'))]\n"
        "assert 'smolvision_tpu_torch.runtime.engine' in sys.modules\n"
        "assert 'smolvision_tpu_torch.runtime.serving' in sys.modules\n"
        "assert 'smolvision_tpu_torch.runtime.stream' in sys.modules\n"
        "assert 'smolvision_tpu_torch.io.live' in sys.modules\n"
        "assert 'smolvision_tpu_torch.runtime.multistream' in sys.modules\n"
        "assert 'smolvision_tpu_torch.runtime.sampling' in sys.modules\n"
        "assert 'smolvision_tpu_torch.models.q25_encoder' in sys.modules\n"
        "assert 'smolvision_tpu_torch.models.moe' in sys.modules\n"
        "assert 'smolvision_tpu_torch.models.moe_offload' in sys.modules\n"
        "assert 'smolvision_tpu_torch.parallel.mesh' in sys.modules\n"
        "assert 'smolvision_tpu_torch.ops.collectives' in sys.modules\n"
        "assert 'smolvision_tpu_torch.utils.native' in sys.modules\n"
        "print('BAD', bad)\n")
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_sources_name_no_jax_import(path):
    bad = [m for m in _imports(REPO / path) if _is_jax_package(m)]
    assert not bad, f"{path} imports {bad}"


def test_port_never_loads_the_jax_packages_native_library(tiny_model_dir):
    """The four callers of the host runtime library map the port's own build
    (build/smolvision_tpu_torch/, from utils/csrc/) and never
    native/libsmolvision_host.so, which the JAX package loads."""
    r = _run("import numpy as np\n"
             "from smolvision_tpu_torch.io.wav import resample_sinc\n"
             "from smolvision_tpu_torch.runtime.sampling import _libc_expf\n"
             "from smolvision_tpu_torch.runtime.segment import compact_silence\n"
             "from smolvision_tpu_torch.text.tokenizer import load_tokenizer\n"
             "from smolvision_tpu_torch.utils import native\n"
             "x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)\n"
             "resample_sinc(x, 8000, 16000); compact_silence(x); _libc_expf(x)\n"
             f"load_tokenizer({tiny_model_dir!r}).encode('language English')\n"
             "maps = open('/proc/self/maps').read()\n"
             "print('PORT', str(native.lib_path()) in maps)\n"
             "print('JAX', 'libsmolvision_host.so' in maps)\n")
    assert r.returncode == 0, r.stderr
    assert "PORT True" in r.stdout and "JAX False" in r.stdout, r.stdout


def test_engine_without_card_raises(tiny_model_dir):
    r = _run("from smolvision_tpu_torch.runtime.engine import Engine\n"
             f"Engine({tiny_model_dir!r})\n")
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr


_FACTORY_CALLS = {
    "load_qwen3_encoder": "P.load_qwen3_encoder(MultiSafetensors(d), cfg)",
    "load_decoder": "P.load_decoder(MultiSafetensors(d), cfg)",
    "load_q25_encoder": "P.load_q25_encoder(MultiSafetensors(d), cfg)",
    "params_from_jax": "P.params_from_jax({}, {})",
    "make_kv_cache": "D.make_kv_cache(cfg, 64)",
    "make_batched_kv": "D.make_batched_kv(cfg, 2, 64)",
    "kv_zeros": "Q.kv_zeros((2, 4, 8), torch.bfloat16)",
}


@pytest.mark.parametrize("factory", sorted(_FACTORY_CALLS))
def test_model_factory_without_card_raises(tiny_model_dir, factory):
    """A weight loader or cache allocator called with no device puts its
    tensors on the card, never quietly on the CPU: without a card it
    raises."""
    r = _run("import torch\n"
             "from smolvision_tpu_torch.config import detect_config\n"
             "from smolvision_tpu_torch.io.safetensors import MultiSafetensors\n"
             "from smolvision_tpu_torch.models import params as P, qwen3_decoder as D\n"
             "from smolvision_tpu_torch.ops import quant as Q\n"
             f"d = {tiny_model_dir!r}\n"
             "cfg = detect_config(d)\n"
             f"{_FACTORY_CALLS[factory]}\n")
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr, r.stderr[-2000:]


def test_cli_without_card_fails_and_names_the_switch(tiny_model_dir, tmp_path):
    wav = tmp_path / "x.wav"
    wav.write_bytes(b"")
    r = _run("import sys\nfrom smolvision_tpu_torch import cli\n"
             f"sys.exit(cli.main(['-d', {tiny_model_dir!r}, '-i', {str(wav)!r}, '--silent']))\n")
    assert r.returncode == 1
    assert "SMOLVISION_PLATFORM=cpu" in r.stderr and r.stdout == ""


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_checkout(tmp_path, alone):
    """No card: exit non-zero and no result line; likewise for the script
    copied alone into an empty directory."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       timeout=120, env=env, cwd=script.parent)
    assert r.returncode != 0
    assert r.stdout == ""
    assert ("run it from a checkout" if alone else "needs a CUDA card") in r.stderr
