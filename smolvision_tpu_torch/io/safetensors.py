"""Zero-copy safetensors reader and a minimal writer (host side).

Port of smolvision_tpu/io/safetensors.py.  Each shard is mmapped once and
`get` hands out torch tensors viewing the map (bf16 stays bf16: torch has
the dtype natively, so no numpy extension type is needed).  Callers copy
what they keep (`.to(device, dtype)`), so the map can close under them.

Supports:
  * single-file ``model.safetensors``,
  * ``model.safetensors.index.json`` weight maps,
  * bare ``model-XXXXX-of-YYYYY.safetensors`` shard scans (sorted).
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import warnings
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """One mmap'd .safetensors shard."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        (header_len,) = struct.unpack("<Q", self._mm[:8])
        header = json.loads(self._mm[8 : 8 + header_len].decode("utf-8"))
        header.pop("__metadata__", None)
        self._data_off = 8 + header_len
        self.tensors: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            begin, end = info["data_offsets"]
            self.tensors[name] = (info["dtype"], tuple(info["shape"]), begin, end)

    def names(self):
        return self.tensors.keys()

    def get(self, name: str) -> torch.Tensor:
        """Zero-copy, read-only view of a tensor in its stored dtype."""
        dtype_str, shape, begin, end = self.tensors[name]
        dt = _DTYPES.get(dtype_str)
        if dt is None:
            raise ValueError(f"unsupported safetensors dtype {dtype_str!r} for {name}")
        if end == begin:
            return torch.empty(shape, dtype=dt)
        buf = memoryview(self._mm)[self._data_off + begin : self._data_off + end]
        with warnings.catch_warnings():
            # the map is read-only; nothing writes through these views
            warnings.simplefilter("ignore", UserWarning)
            return torch.frombuffer(buf, dtype=dt).reshape(shape)

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # views of this map are still alive; leave the mapping open — the
            # OS reclaims it when the views die
            return
        finally:
            self._f.close()


class MultiSafetensors:
    """All shards of one checkpoint directory, unified by tensor name."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self.files: Dict[str, SafetensorsFile] = {}
        self._name_to_file: Dict[str, str] = {}

        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        single_path = os.path.join(model_dir, "model.safetensors")
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
            shard_paths = sorted(
                os.path.join(model_dir, s) for s in set(index["weight_map"].values())
            )
        elif os.path.exists(single_path):
            shard_paths = [single_path]
        else:
            shard_paths = sorted(glob.glob(os.path.join(model_dir, "model-*.safetensors")))
        if not shard_paths:
            raise FileNotFoundError(f"no safetensors files in {model_dir}")

        for path in shard_paths:
            sf = SafetensorsFile(path)
            self.files[path] = sf
            for name in sf.names():
                self._name_to_file[name] = path

    def has(self, name: str) -> bool:
        return name in self._name_to_file

    def names(self):
        return self._name_to_file.keys()

    def get(self, name: str) -> torch.Tensor:
        path = self._name_to_file.get(name)
        if path is None:
            raise KeyError(f"weight not found: {name}")
        return self.files[path].get(name)

    def get_optional(self, name: str) -> Optional[torch.Tensor]:
        if name not in self._name_to_file:
            return None
        return self.get(name)

    def close(self):
        for sf in self.files.values():
            sf.close()
        self.files.clear()
        self._name_to_file.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_safetensors(path: str,
                      tensors: Mapping[str, Union[torch.Tensor, np.ndarray]]) -> None:
    """Minimal safetensors writer; values are torch tensors or numpy arrays."""
    header = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        t = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) \
            else arr.detach().cpu().contiguous()
        dt = _NAMES.get(t.dtype)
        if dt is None:
            raise ValueError(f"unsupported dtype {t.dtype} for {name}")
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": dt,
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        blobs.append(t.reshape(-1).view(torch.uint8).numpy() if nbytes else b"")
        offset += nbytes
    hjson = json.dumps(header).encode("utf-8")
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
