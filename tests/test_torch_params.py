"""Port weight loading: params_from_jax (the JAX loaders' pytrees as numpy)
gives the same tensors as the port's own safetensors loader, and the port's
synthetic checkpoints are byte-identical to tools/make_tiny_model's."""

import filecmp
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from smolvision_tpu.config import detect_config as j_detect
from smolvision_tpu.io.safetensors import MultiSafetensors as JReader
from smolvision_tpu.models import params as jpm
from smolvision_tpu_torch.config import detect_config
from smolvision_tpu_torch.io.safetensors import MultiSafetensors
from smolvision_tpu_torch.models import params as tpm
from smolvision_tpu_torch.models import synthetic


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_params_from_jax_equals_own_loader(tiny_model_dir, jdt, tdt):
    reader = JReader(tiny_model_dir)
    jcfg = j_detect(tiny_model_dir, reader)
    enc_np = jax.tree_util.tree_map(np.asarray, jpm.load_qwen3_encoder(reader, jcfg, jdt))
    dec_j = jpm.load_decoder(reader, jcfg, jdt)
    reader.close()
    dec_np = jax.tree_util.tree_map(np.asarray, dec_j)
    enc_a, dec_a = tpm.params_from_jax(enc_np, dec_np, "cpu", tdt)

    with MultiSafetensors(tiny_model_dir) as r:
        cfg = detect_config(tiny_model_dir, r)
        enc_b = tpm.load_qwen3_encoder(r, cfg, tdt, "cpu")
        dec_b = tpm.load_decoder(r, cfg, tdt, "cpu")

    for a_tree, b_tree in ((enc_a, enc_b), (dec_a, dec_b)):
        a, b = dict(_flat(a_tree)), dict(_flat(b_tree))
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            assert torch.equal(a[name], b[name]), name
    assert dec_a["lm_head"] is dec_a["embed"] and dec_b["lm_head"] is dec_b["embed"]
    assert dec_b["layers"]["wqkv"].dtype == tdt
    assert dec_b["layers"]["q_norm"].dtype == torch.float32


@pytest.mark.parametrize("dtype,full_vocab", [("bf16", False), ("f32", True)])
def test_synthetic_checkpoint_is_byte_identical(tmp_path, dtype, full_vocab):
    from tools.make_tiny_model import build

    a = build("tiny", str(tmp_path / "tool"), seed=3, dtype=dtype, full_vocab=full_vocab)
    b = synthetic.build("tiny", str(tmp_path / "port"), seed=3, dtype=dtype,
                        full_vocab=full_vocab)
    for name in ("model.safetensors", "config.json", "vocab.json", "merges.txt"):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def test_safetensors_reader_roundtrip(tmp_path):
    from smolvision_tpu_torch.io.safetensors import write_safetensors

    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
         "c": np.arange(4, dtype=np.int32), "e": torch.zeros(0)}
    write_safetensors(str(tmp_path / "model.safetensors"), t)
    with MultiSafetensors(str(tmp_path)) as r:
        assert torch.equal(r.get("a"), t["a"])
        assert r.get("b").dtype == torch.bfloat16 and torch.equal(r.get("b"), t["b"])
        assert torch.equal(r.get("c"), torch.from_numpy(t["c"]))
        assert r.get("e").shape == (0,)
    with JReader(str(tmp_path)) as jr:  # the JAX reader reads the port's file
        np.testing.assert_array_equal(jr.get("a"), t["a"].numpy())
        np.testing.assert_array_equal(np.asarray(jr.get("b"), np.float32), [1.5, -2.0])
