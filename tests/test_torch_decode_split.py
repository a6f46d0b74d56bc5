"""The partitions of the redesigned kernels B3 and K9, emulated in plain torch.

csrc/decode_attention.cu (B3) splits one position's attention over the
live cache rows into a thread block cluster of a fixed DECODE_MAX_BLOCKS
blocks per KV head, each taking ceil(live / DECODE_MAX_BLOCKS) rows, which
it works out from the position it reads from device memory (a block with
no row leaves an empty partial); inside a block the rows go in tiles
of WARP_TILE_BYTES (K + V) to the warps in turn; each warp keeps an online
softmax with one max and one rescale per tile; the block merges its warps
at one max; the cluster merges its blocks and the fresh row.  The emulation
below does exactly that, step for step, and is held against the Pallas
kernel (`decode_flash_attention`, interpret mode off-TPU, as in
tests/test_kernels.py) and against `decode_attention_plain` in both forms
(host ints, and the fixed-shape form at a device position).  Tolerance
1e-5: all three are f32 softmax-attention over <= 4096 keys of outputs of
magnitude <~ 3 and differ only in summation order (~1e-6); a row counted
twice or missed, or a wrong merge factor, moves outputs by > 1e-3.

csrc/probes.cu (K9) tiles x @ y into 16 x 32 output blocks, 128-deep k
tiles zero-filled past the ragged edges, 8 warps on 16-deep k slices of
each tile, the slices summed at the end; emulated on ragged M, N, K and
held against numpy and the probe's Pallas body in interpret mode.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from smolvision_tpu.kernels import flash_attention as jfa
from smolvision_tpu_torch.kernels import flash_attention as tfa
from smolvision_tpu_torch.kernels import probes as tprobes

TOL = dict(rtol=1e-5, atol=1e-5)
# the kernels' constants (csrc/decode_attention.cu, csrc/probes.cu)
WARPS = 8
WARP_TILE_BYTES = 4096
MM_BM, MM_BN, MM_KT, MM_WARPS = 16, 32, 128, 8


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _merge(parts):
    """(m, l, acc) partials [G], [G], [G, D] brought to one max."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    f = [torch.exp(m - mx) for m, _, _ in parts]
    l = sum(fi * li for fi, (_, li, _) in zip(f, parts))
    acc = sum(fi[:, None] * a for fi, (_, _, a) in zip(f, parts))
    return mx, l, acc


def decode_emulated(q, k_new, v_new, k_cache, v_cache, start: int, kv_min: int):
    """B3's partition: clusters of blocks, warp tiles, per-tile online
    softmax, block and cluster merges, the fresh row last.  Also checks
    that the blocks' tiles cover the live rows once each."""
    H, D = q.shape
    KH = k_new.shape[0]
    G = H // KH
    n = tfa.DECODE_MAX_BLOCKS
    chunk = -(-max(start - kv_min, 0) // n)
    tile = WARP_TILE_BYTES // (2 * D * k_cache.element_size())
    qs = (q.float() * (1.0 / math.sqrt(D))).reshape(KH, G, D)
    out = torch.empty(KH, G, D)
    seen = torch.zeros(k_cache.shape[0], dtype=torch.int64)
    for kh in range(KH):
        blocks = []
        for r in range(n):
            lo = kv_min + r * chunk
            hi = min(lo + chunk, start)
            n_tiles = -(-(hi - lo) // tile) if hi > lo else 0
            warps = []
            for w in range(WARPS):
                m = torch.full((G,), tfa.NEG_INF)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for t in range(w, n_tiles, WARPS):
                    a, b = lo + t * tile, min(lo + (t + 1) * tile, hi)
                    if kh == 0:
                        seen[a:b] += 1
                    s = qs[kh] @ k_cache[a:b, kh].float().T             # [G, rows]
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    m = m_new
                    p = torch.exp(s - m[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ v_cache[a:b, kh].float()
                warps.append((m, l, acc))
            blocks.append(_merge(warps))
        s_self = qs[kh] @ k_new[kh].float()
        fresh = (s_self, torch.ones(G), v_new[kh].float()[None, :].expand(G, D))
        _, l, acc = _merge(blocks + [fresh])
        out[kh] = acc / torch.clamp(l, min=tfa.DENOM_FLOOR)[:, None]
    live = torch.zeros_like(seen)
    live[min(kv_min, start):start] = 1
    assert torch.equal(seen, live), "the tiles must cover each live row exactly once"
    return out.reshape(H, D)


@pytest.mark.parametrize("K,H,KH,D,start,kv_min,cache", [
    (256, 8, 4, 64, 0, 0, "f32"),          # empty cache: the fresh row alone, 8 empty blocks
    (256, 8, 4, 64, 1, 0, "f32"),          # one live row: one block, 7 empty
    (256, 8, 8, 64, 37, 0, "f32"),         # G 1; 37 rows: 7 blocks of 5 and one of 2
    (512, 8, 1, 128, 315, 0, "f32"),       # G 8; the offline run's live range
    (1024, 16, 8, 128, 315, 0, "bf16"),    # the 0.6B head layout on a bf16 cache
    (512, 16, 8, 128, 300, 17, "f32"),     # kv_min > 0 (left-padded layout)
    (256, 8, 4, 64, 20, 30, "f32"),        # kv_min past start: the fresh row alone
    (4096, 4, 2, 64, 4095, 0, "f32"),      # a long context: 8 blocks of 512 rows
    (4096, 8, 1, 64, 4095, 100, "bf16"),   # G 8, long, kv_min > 0
])
def test_decode_partition_matches_pallas_and_plain(K, H, KH, D, start, kv_min, cache):
    rng = np.random.default_rng(K + start + kv_min)
    q = _rand(rng, H, D)
    k_new, v_new = _rand(rng, KH, D), _rand(rng, KH, D)
    k, v = _rand(rng, K, KH, D), _rand(rng, K, KH, D)
    k[start:] = 999.0  # rows at or past start_pos are never attended
    v[start:] = -999.0
    dt_t, dt_j = (torch.bfloat16, jnp.bfloat16) if cache == "bf16" else (torch.float32,
                                                                          jnp.float32)
    tq, tkn, tvn = map(torch.from_numpy, (q, k_new, v_new))
    tk, tv = torch.from_numpy(k).to(dt_t), torch.from_numpy(v).to(dt_t)
    got = decode_emulated(tq, tkn, tvn, tk, tv, start, kv_min).numpy()
    plain = tfa.decode_attention_plain(tq, tkn, tvn, tk, tv, start, kv_min).numpy()
    masked = tfa.decode_attention_plain(tq, tkn, tvn, tk, tv, torch.tensor([start]),
                                        torch.tensor(kv_min)).numpy()
    want = jfa.decode_flash_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(k, dt_j),
        jnp.asarray(v, dt_j), jnp.int32(start), jnp.int32(kv_min), gqa_groups=H // KH)
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, masked, **TOL)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def probe_mm_emulated(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K9's partition: 16 x 32 output blocks, 128-deep k tiles zero-filled
    past the edges, each warp's 16-deep k slices summed over the tiles, the
    8 warps' sums added in order."""
    M, K = x.shape
    N = y.shape[1]
    Mp, Np = -(-M // MM_BM) * MM_BM, -(-N // MM_BN) * MM_BN
    Kp = -(-K // MM_KT) * MM_KT
    xp = torch.zeros(Mp, Kp)
    yp = torch.zeros(Kp, Np)
    xp[:M, :K], yp[:K, :N] = x, y
    out = torch.empty(Mp, Np)
    sl = MM_KT // MM_WARPS
    for m0 in range(0, Mp, MM_BM):
        for n0 in range(0, Np, MM_BN):
            warps = torch.zeros(MM_WARPS, MM_BM, MM_BN)
            for k0 in range(0, Kp, MM_KT):
                for w in range(MM_WARPS):
                    a = k0 + w * sl
                    warps[w] += xp[m0:m0 + MM_BM, a:a + sl] @ yp[a:a + sl, n0:n0 + MM_BN]
            out[m0:m0 + MM_BM, n0:n0 + MM_BN] = warps.sum(0)
    return out[:M, :N]


def _pallas_mm(x, y):
    # the body of tools/probe_compile_cache.py:pallas_mm (that script runs at
    # import), at any shape
    def kern(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] @ y_ref[...]

    return pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((x.shape[0], y.shape[1]),
                                                               jnp.float32),
                          interpret=True)(x, y)


@pytest.mark.parametrize("M,N,K", [(256, 256, 256), (17, 33, 5), (100, 70, 300),
                                   (255, 257, 129)])
def test_probe_mm_partition_matches_pallas_and_numpy(M, N, K):
    """Outputs of magnitude ~1 (inputs / 4); f32 sums of <= 300 terms in
    another order: 1e-5."""
    rng = np.random.default_rng(M * N + K)
    x, y = _rand(rng, M, K) / 4, _rand(rng, K, N) / 4
    got = probe_mm_emulated(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, x @ y, **TOL)
    np.testing.assert_allclose(got, np.asarray(_pallas_mm(jnp.asarray(x), jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(tprobes.probe_mm(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               x @ y, **TOL)
