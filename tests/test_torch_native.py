"""The port's host runtime library (utils/native.py, built by gcc from
utils/csrc/smolvision_host.c) against the port's numpy routes and the JAX
package's results for the same inputs: the keep mask and the BPE ids bit
for bit, expf bit for bit against libm's scalar expf per element, the
resampler to tests/test_native.py's tolerance (rtol 1e-5, atol 1e-6).  A
failed build raises.
"""

import numpy as np
import pytest

from smolvision_tpu.io import wav as jwav
from smolvision_tpu.runtime import sampling as jsampling
from smolvision_tpu.runtime import segment as jseg
from smolvision_tpu.text.tokenizer import load_tokenizer as jload_tokenizer
from smolvision_tpu_torch.io import wav as twav
from smolvision_tpu_torch.runtime import sampling as tsampling
from smolvision_tpu_torch.runtime import segment as tseg
from smolvision_tpu_torch.text.tokenizer import load_tokenizer
from smolvision_tpu_torch.utils import native


@pytest.mark.parametrize("rates", [(44100, 16000), (8000, 16000), (22050, 16000)])
def test_resample_matches_numpy_and_jax(rates):
    in_rate, out_rate = rates
    x = (np.random.default_rng(in_rate).standard_normal(in_rate) * 0.3).astype(np.float32)
    got = twav.resample_sinc(x, in_rate, out_rate)
    want = twav._resample_sinc_numpy(x, in_rate, out_rate)
    assert got.shape == want.shape == (out_rate,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jwav.resample_sinc(x, in_rate, out_rate), rtol=1e-5,
                               atol=1e-6)


def test_bpe_ids_match_python_merge_and_jax(tiny_model_dir):
    tok = load_tokenizer(tiny_model_dir)
    jtok = jload_tokenizer(tiny_model_dir)
    assert tok._native_table is not None
    rng = np.random.default_rng(11)
    texts = ["the theme and the thing", "language English", "héllo wörld 音声", "a" * 500,
             "th" * 200]
    pools = ((32, 127), (0x4E00, 0x9FFF), (0x1F300, 0x1F64F), (0x300, 0x370))   # ASCII, CJK, ...
    for _ in range(40):
        texts.append("".join(chr(int(rng.integers(*pools[int(rng.integers(len(pools)))])))
                             for _ in range(int(rng.integers(1, 60)))))
    for text in texts:
        ids = tok.encode(text)
        assert ids == tok._encode_python(text.encode("utf-8")) == jtok.encode(text), text
        assert tok.decode(ids) == text


@pytest.mark.parametrize("trial", range(4))
def test_keep_mask_matches_numpy_and_jax(trial):
    rng = np.random.default_rng(30 + trial)
    n = int(rng.integers(16000 // 4, 4 * 16000))
    x = (rng.standard_normal(n) * rng.uniform(0.002, 0.4)).astype(np.float32)
    for _ in range(int(rng.integers(1, 4))):
        a = int(rng.integers(0, max(n - 4000, 1)))
        x[a : a + 4000] *= np.float32(rng.uniform(0, 0.02))
    got = native.silence_keep_mask(x)
    assert np.array_equal(got, tseg._silence_keep_mask_numpy(x))
    assert np.array_equal(got, jseg._silence_keep_mask_numpy(x))
    np.testing.assert_array_equal(tseg.compact_silence(x), jseg.compact_silence(x))


def test_expf_is_libm_per_element_and_jax():
    xs = np.random.default_rng(0).uniform(-100, 1, 20000).astype(np.float32)
    got = tsampling._libc_expf(xs)
    assert got.dtype == np.float32
    assert np.array_equal(got, tsampling._libc_expf_ctypes(xs))
    assert np.array_equal(got, jsampling._libc_expf(xs))


def test_library_is_built_from_the_port_source_by_hash():
    native.load()
    path = native.lib_path()
    assert path.parent == native.BUILD_ROOT and path.exists()
    assert path.parent.parts[-2:] == ("build", "smolvision_tpu_torch")
    assert native.SOURCE.parent.parent.name == "utils"
    assert "-ffast-math" not in native.CFLAGS


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "smolvision_host.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="gcc failed"):
        native.load()
    with pytest.raises(RuntimeError, match="gcc failed"):
        twav.resample_sinc(np.zeros(100, np.float32), 8000, 16000)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="gcc not found"):
        native.load()
    assert not list((tmp_path / "build").glob("*.so"))
