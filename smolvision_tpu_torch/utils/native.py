"""ctypes bindings of the host runtime library (csrc/smolvision_host.c).

Port of smolvision_tpu/utils/native.py.  The library is built at first use
by `gcc` from the port's own copy of the C source, into
`build/smolvision_tpu_torch/` at the repository root (listed in
.gitignore), named by a hash of the source and the flags: an edited source
rebuilds, an unchanged one loads the library already there.  The flags are
the JAX package's (no -ffast-math, so `sv_expf_vec` stays libm's scalar
expf per element).

Its four callers take it as their route: `io/wav.resample_sinc`, the
tokenizer's BPE encode, `runtime/segment.compact_silence` and
`runtime/sampling.CRefSampler`.  A failed build raises; nothing drops to
the numpy versions, which stay beside each caller as its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "smolvision_host.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "smolvision_tpu_torch"
CFLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-std=c11", "-shared"]
LDFLAGS = ["-lm"]

_lib = None
_lock = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS + LDFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"libsmolvision_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raise with the
    compiler's output when gcc is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    cc = shutil.which("gcc")
    if cc is None:
        raise RuntimeError("gcc not found: the host runtime library is built with gcc")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE), *LDFLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"gcc failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.sv_resample_len.restype = ctypes.c_long
            lib.sv_resample_len.argtypes = [ctypes.c_long] * 3
            lib.sv_resample_sinc.restype = None
            lib.sv_resample_sinc.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_float)]
            lib.sv_bpe_encode.restype = ctypes.c_int
            lib.sv_bpe_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
            lib.sv_silence_mask.restype = None
            lib.sv_silence_mask.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.sv_expf_vec.restype = None
            lib.sv_expf_vec.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_long]
            _lib = lib
        return _lib


def _f32p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample_sinc(samples: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Kaiser-windowed sinc resample of f32 samples (`sv_resample_sinc`)."""
    if in_rate <= 0 or out_rate <= 0:
        raise ValueError(f"sample rates must be positive, not {in_rate} -> {out_rate}")
    lib = load()
    x = np.ascontiguousarray(samples, dtype=np.float32)
    out = np.empty(lib.sv_resample_len(len(x), in_rate, out_rate), dtype=np.float32)
    lib.sv_resample_sinc(_f32p(x), len(x), in_rate, out_rate, _f32p(out))
    return out


def bpe_encode(initial_ids: np.ndarray, keys: np.ndarray, ranks: np.ndarray,
               results: np.ndarray) -> np.ndarray:
    """Lowest-rank-first BPE merge over int32 ids (`sv_bpe_encode`); the merge
    table (keys int64 (a << 32) | b, sorted; ranks and results int32) as
    the tokenizer flattens it."""
    if not (keys.dtype == np.int64 and ranks.dtype == results.dtype == np.int32
            and len(keys) == len(ranks) == len(results)
            and all(a.flags.c_contiguous for a in (keys, ranks, results))):
        raise ValueError("the merge table must be contiguous int64 keys and int32 ranks / "
                         "results of one length")
    lib = load()
    buf = np.array(initial_ids, dtype=np.int32)
    n = ctypes.c_long(len(buf))
    rc = lib.sv_bpe_encode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(n),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        results.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(keys))
    if rc != 0:
        raise MemoryError(f"sv_bpe_encode could not allocate its lists for {len(buf)} ids")
    return buf[: n.value]


def silence_keep_mask(samples: np.ndarray) -> np.ndarray:
    """Keep mask per 10 ms window (`sv_silence_mask`), bool [ceil(n / 160)]."""
    lib = load()
    x = np.ascontiguousarray(samples, dtype=np.float32)
    keep = np.zeros((len(x) + 159) // 160, dtype=np.uint8)
    lib.sv_silence_mask(_f32p(x), len(x), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)


def expf_vec(x: np.ndarray) -> np.ndarray:
    """libm's expf of each element of a 1-D array (`sv_expf_vec`), as a new
    f32 array."""
    lib = load()
    out = np.array(x, dtype=np.float32).reshape(-1)
    lib.sv_expf_vec(_f32p(out), out.shape[0])
    return out
