"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` file is one shared library with a plain C interface,
compiled by `nvcc` for sm_90a (Hopper).  All missing libraries are built
at once, one `nvcc` process per source started together.  Outputs go to
`build/smolvision_tpu_torch/` at the repository root (listed in
.gitignore), named by a hash of every source and flag, so an edited
source rebuilds and an unchanged one loads the library already there.

Nothing here runs at import: the CPU tests import the kernel modules on a
host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "smolvision_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIBS = ("window_attention", "causal_cache_attention", "decode_attention",
        "batched_causal_attention", "batched_cache_attention", "argmax_matvec", "probes")

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildLog:
    name: str
    seconds: float  # 0.0 when the library was already built
    ptxas: str      # nvcc's -Xptxas -v report (registers, shared memory, spills)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_ROOT / f"lib{name}-{_digest()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return found


def build_all() -> List[BuildLog]:
    """Compile every library that is not built yet, in parallel; raise on
    the first compiler failure with its output."""
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    todo = [n for n in LIBS if not lib_path(n).exists()]
    logs = [BuildLog(n, 0.0, "") for n in LIBS if n not in todo]
    if not todo:
        return logs
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, lib_path(name))
        logs.append(BuildLog(name, time.monotonic() - t0, out))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building the kernels first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib
