"""The port's continuous-batching scheduler against the JAX package's and its
own static batch, on the tiny f32 checkpoint with the full vocabulary (every
decoded id is visible text); and the CLI's several-file modes byte-equal to
the JAX CLI under --f32.

Admission waves, slot reuse, the per-row region_start mask of late rows and
admit_cap may never change greedy tokens: rows are independent.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from smolvision_tpu.runtime import serving as jserving
from smolvision_tpu.runtime.engine import Engine as JEngine
from smolvision_tpu_torch.parallel import batch as tbatch
from smolvision_tpu_torch.runtime import batch_segments as tbs
from smolvision_tpu_torch.runtime import serving as tserving
from smolvision_tpu_torch.runtime.engine import Engine
from tests.workloads import serving_clips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def visible_model_dir(tmp_path_factory):
    from tools.make_tiny_model import build

    return build("tiny", str(tmp_path_factory.mktemp("visible") / "model"), seed=5,
                 dtype="f32", full_vocab=True)


@pytest.fixture(scope="module")
def engines(visible_model_dir):
    j = JEngine(visible_model_dir, param_dtype=jnp.float32, kv_dtype=jnp.float32)
    t = Engine(visible_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
               device="cpu")
    for eng in (j, t):
        eng.max_tokens = 8
        eng.set_force_language("English")
    return j, t


@pytest.mark.parametrize("n,slots,admit_cap", [
    (5, 2, 0),    # three waves, slot reuse, late rows masked by region_start
    (6, 4, 2),    # admit_cap: sub-waves of 2 into a 4-slot batch
    (3, 8, 0),    # one wave: everything fits
])
def test_serve_continuous_matches_jax_and_static_batch(engines, n, slots, admit_cap):
    jeng, teng = engines
    clips = serving_clips(n, seed=21 + n)
    want = jserving.serve_continuous(jeng, clips, slots=slots, admit_cap=admit_cap)
    teng.perf.reset()
    got = tserving.serve_continuous(teng, clips, slots=slots, admit_cap=admit_cap)
    assert got == want and any(got)
    assert got == tbs.transcribe_segments_batched(teng, clips)
    lat = teng.perf.serving_latency
    assert lat["clips"] == n and lat["ttft_p50_ms"] <= lat["done_p99_ms"]
    waves = -(-n // min(slots, admit_cap or slots))
    assert teng.perf.delta_prefills >= waves


def test_serving_raw_rows_equal_static_batch_rows(engines):
    """Raw token rows, not only texts: the scheduler's rows (cut at EOS) are
    the static batch's."""
    _, teng = engines
    clips = serving_clips(5, seed=3)
    rows = tserving.decode_continuous(teng, clips, slots=2)
    want = tbs.decode_segments_batched(teng, clips)
    assert [tbatch.trim_eos(r) for r in rows] == [tbatch.trim_eos(r) for r in want]


def test_admit_rows_copies_block_rows():
    big = torch.zeros(2, 2, 4, 1, 8, 2)
    small = torch.arange(2 * 2 * 2 * 1 * 5 * 2, dtype=torch.float32).reshape(2, 2, 2, 1, 5, 2)
    tbatch.admit_rows(big, small, [3, 1], 2, src=[1, 0])
    assert torch.equal(big[:, :, 3, :, :5], small[:, :, 1])
    assert torch.equal(big[:, :, 1, :, :5], small[:, :, 0])
    assert not big[:, :, (0, 2)].any() and not big[..., 5:, :].any()


def _wav_bytes(samples, rate=16000):
    import struct

    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for i, clip in enumerate(serving_clips(3, seed=5)):
        p = d / f"clip{i}.wav"
        p.write_bytes(_wav_bytes(clip))
        paths.append(str(p))
    return paths


def _cli(module, args):
    env = dict(os.environ, PYTHONPATH=REPO, SMOLVISION_PLATFORM="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, capture_output=True,
                          timeout=600, env=env, cwd=REPO)


@pytest.mark.parametrize("extra", [["--serve", "2"], ["--serve", "2", "--serve-admit", "1"]])
def test_cli_serve_stdout_byte_equal(visible_model_dir, wavs, extra):
    args = ["-d", visible_model_dir, "-i", *wavs, "--f32", "--language", "English",
            "--max-tokens", "8"] + extra
    j = _cli("smolvision_tpu.cli", args)
    t = _cli("smolvision_tpu_torch.cli", args)
    assert j.returncode == 0, j.stderr.decode()
    assert t.returncode == 0, t.stderr.decode()
    assert len(t.stdout.decode().splitlines()) == 3 and t.stdout.strip()
    assert t.stdout == j.stdout
    err = t.stderr.decode()
    assert "Batch: 3 files" in err and "Serve: ttft p50" in err
