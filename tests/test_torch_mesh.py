"""The port's device mesh (smolvision_tpu_torch/parallel/mesh.py) in one
process, against the JAX package's smolvision_tpu/parallel/mesh.py.

  * the TP interleave of the fused QKV / gate_up rows is the JAX package's,
    bit for bit, brought over by params_from_jax (tp 2 / 4, with and
    without the Qwen2.5-Omni QKV bias);
  * a rank's interleaved shard splits, as the whole fusion does, into
    exactly its chunk of the plain heads and channels (the port's form of
    tests/test_tp.py), and the ranks' partial o-projections, FFNs and
    expert shares sum to the one-device layer;
  * shard_params keeps each rank exactly the block the JAX package's
    device_put puts on that device, the tied head one tensor;
  * the vocabulary-sharded head's packed keys reduce to the single-device
    argmax across a shard-boundary tie and over negative logits;
  * make_mesh's tp default.
Multi-rank runs are in tests/test_torch_mesh_dist.py.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from smolvision_tpu.config import QWEN3_ASR_06B as J_06B
from smolvision_tpu.models.synthetic import synthetic_decoder
from smolvision_tpu.parallel import mesh as jmesh
from smolvision_tpu_torch.config import QWEN3_ASR_06B as T_06B
from smolvision_tpu_torch.kernels import argmax_matvec as am
from smolvision_tpu_torch.models import qwen3_decoder as dec
from smolvision_tpu_torch.models.params import params_from_jax
from smolvision_tpu_torch.ops.common import linear
from smolvision_tpu_torch.parallel import mesh as tmesh

GEOM = dict(dec_hidden=128, dec_layers=2, dec_heads=16, dec_kv_heads=8, dec_head_dim=16,
            dec_intermediate=256, vocab_size=2048)


def _cfgs(**extra):
    return (dataclasses.replace(J_06B, **GEOM, **extra),
            dataclasses.replace(T_06B, **GEOM, **extra))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


def _port(jparams):
    return params_from_jax({}, _np_tree(jparams), device="cpu", dtype=torch.float32)[1]


@pytest.fixture(scope="module", params=[False, True], ids=["qwen3", "bqkv"])
def decoder(request):
    bias = request.param
    jcfg, tcfg = _cfgs(dec_qkv_bias=bias, dec_qk_norm=not bias)
    jparams = synthetic_decoder(jcfg, param_dtype=jnp.float32, seed=3)
    return jcfg, tcfg, jparams, _port(jparams)


@pytest.mark.parametrize("tp", [2, 4])
def test_interleave_matches_jax_bit_for_bit(decoder, tp):
    jcfg, tcfg, jparams, tparams = decoder
    want = _port(jmesh.interleave_decoder_for_tp(jparams, jcfg, tp))
    got = tmesh.interleave_decoder_for_tp(tparams, tcfg, tp)
    for key in ("wqkv", "bqkv", "w_gate_up", "wo", "w_down"):
        if key not in want["layers"]:
            assert got["layers"].get(key) is None
            continue
        assert torch.equal(got["layers"][key], want["layers"][key]), key
    assert got["embed"] is tparams["embed"] and got["lm_head"] is got["embed"]


def _rank_view(tp, r):
    return SimpleNamespace(shape={"data": 1, "model": tp}, coord={"data": 0, "model": r})


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_rank_shard_splits_into_its_heads(decoder, tp):
    """tests/test_tp.py:30,48 in the port's SPMD form: after the interleave
    and shard_params, rank r's fused rows, split as the whole fusion is
    split (`_split_qkv`, `_split_gate_up`) at H/tp and KH/tp heads, are
    exactly heads (channels) chunk r of the plain weights, and its wo /
    w_down columns exactly the matching input columns: the layout alone
    decides which rank computes what, no arithmetic is involved."""
    _, tcfg, _, tparams = decoder
    H, KH, D = tcfg.dec_heads, tcfg.dec_kv_heads, tcfg.dec_head_dim
    Hl, KHl = H // tp, KH // tp
    plain = tparams["layers"]
    I = plain["w_gate_up"].shape[1] // 2
    Il = I // tp
    inter = tmesh.interleave_decoder_for_tp(tparams, tcfg, tp)
    specs = tmesh.decoder_shardings(tcfg)
    # [L, out, in] -> [L, in, out]: the split acts on the output axis
    pq, pk, pv = dec._split_qkv(plain["wqkv"].transpose(1, 2), H, KH, D)
    pg, pu = dec._split_gate_up(plain["w_gate_up"].transpose(1, 2))
    for r in range(tp):
        lp = tmesh.shard_params(inter, specs, _rank_view(tp, r))["layers"]
        q, k, v = dec._split_qkv(lp["wqkv"].transpose(1, 2), Hl, KHl, D)
        assert torch.equal(q, pq[..., r * Hl : (r + 1) * Hl, :])
        assert torch.equal(k, pk[..., r * KHl : (r + 1) * KHl, :])
        assert torch.equal(v, pv[..., r * KHl : (r + 1) * KHl, :])
        if plain.get("bqkv") is not None:
            bq, bk, bv = dec._split_qkv(lp["bqkv"], Hl, KHl, D)
            wq, wk, wv = dec._split_qkv(plain["bqkv"], H, KH, D)
            assert torch.equal(bq, wq[:, r * Hl : (r + 1) * Hl])
            assert torch.equal(bk, wk[:, r * KHl : (r + 1) * KHl])
            assert torch.equal(bv, wv[:, r * KHl : (r + 1) * KHl])
        assert torch.equal(lp["wo"], plain["wo"][..., r * Hl * D : (r + 1) * Hl * D])
        g, u = dec._split_gate_up(lp["w_gate_up"].transpose(1, 2))
        assert torch.equal(g, pg[..., r * Il : (r + 1) * Il])
        assert torch.equal(u, pu[..., r * Il : (r + 1) * Il])
        assert torch.equal(lp["w_down"], plain["w_down"][..., r * Il : (r + 1) * Il])


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_partials_sum_to_the_plain_layer(tp):
    """What a rank computes between its collectives: the o-projection of its
    heads and the FFN of its channels (`_dense_ffn` on its shard), and the
    MoE FFN of its experts (`moe_dense`, `capacity_dispatch` at its e0),
    summed over the ranks, give the one-device layer within f32 rounding
    (the sum runs in another order); the dispatch's drop counts add up."""
    from smolvision_tpu_torch.models import moe

    _, tcfg = _cfgs()
    tparams = _port(synthetic_decoder(_cfgs()[0], param_dtype=jnp.float32, seed=7))
    inter = tmesh.interleave_decoder_for_tp(tparams, tcfg, tp)
    specs = tmesh.decoder_shardings(tcfg)
    T, Hd = 6, tcfg.dec_heads * tcfg.dec_head_dim
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((T, tcfg.dec_hidden)).astype(np.float32))
    attn = torch.from_numpy(rng.standard_normal((T, Hd)).astype(np.float32))
    layers = [tmesh.shard_params(inter, specs, _rank_view(tp, r))["layers"] for r in range(tp)]
    for i in range(tcfg.dec_layers):
        lp = {k: v[i] for k, v in tparams["layers"].items() if v is not None}
        ranks = [{k: v[i] for k, v in rl.items() if v is not None} for rl in layers]
        per = Hd // tp
        wo = sum(linear(attn[:, r * per : (r + 1) * per], ranks[r]["wo"]) for r in range(tp))
        torch.testing.assert_close(wo, linear(attn, lp["wo"]), rtol=1e-5, atol=1e-5)
        ffn = sum(dec._dense_ffn(x, rl) for rl in ranks)
        torch.testing.assert_close(ffn, dec._dense_ffn(x, lp), rtol=1e-5, atol=1e-5)
    # the expert axis: E experts in tp shares
    E, MI, K, T = 16, 8, 4, 24
    stacks = {"e_gate": (E, MI, tcfg.dec_hidden), "e_up": (E, MI, tcfg.dec_hidden),
              "e_down": (E, tcfg.dec_hidden, MI)}
    lp = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
          for k, s in stacks.items()}
    xm = torch.from_numpy(rng.standard_normal((T, tcfg.dec_hidden)).astype(np.float32))
    # distinct experts per row; two thirds of the rows pick expert 0, past its queue
    top_idx = torch.from_numpy(np.stack([
        np.concatenate([[0], 1 + rng.permutation(E - 1)[: K - 1]]) if t < 2 * T // 3
        else rng.permutation(E)[:K] for t in range(T)]))
    top_w = torch.softmax(torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)), -1)
    valid = torch.ones(T, dtype=torch.bool)
    valid[-1] = False
    whole_out, whole_drop = moe.capacity_dispatch(xm, lp, top_idx, top_w, valid)
    assert int(whole_drop) > 0
    El = E // tp
    shares = [{k: v[r * El : (r + 1) * El] for k, v in lp.items()} for r in range(tp)]
    parts = [moe.capacity_dispatch(xm, sh, top_idx, top_w, valid, r * El, E)
             for r, sh in enumerate(shares)]
    torch.testing.assert_close(sum(o for o, _ in parts), whole_out, rtol=1e-5, atol=1e-5)
    assert sum(int(d) for _, d in parts) == int(whole_drop)
    dense = sum(moe.moe_dense(xm, sh, top_idx, top_w, r * El, E) for r, sh in enumerate(shares))
    torch.testing.assert_close(dense, moe.moe_dense(xm, lp, top_idx, top_w),
                               rtol=1e-5, atol=1e-5)


def _jax_mesh(dp, tp):
    return jax.sharding.Mesh(np.asarray(jax.devices()[: dp * tp]).reshape(dp, tp),
                             (jmesh.DATA_AXIS, jmesh.MODEL_AXIS))


def _each_rank(dp, tp):
    for d in range(dp):
        for m in range(tp):
            yield d, m, SimpleNamespace(shape={"data": dp, "model": tp},
                                        coord={"data": d, "model": m})


def _jax_block(arr, jm, spec, d, m):
    """The block of `arr` that device (d, m) holds under NamedSharding(spec)."""
    dev = jm.devices[d, m]
    placed = jax.device_put(arr, NamedSharding(jm, P(*spec)))
    return next(np.asarray(s.data) for s in placed.addressable_shards if s.device == dev)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_shard_params_match_jax_device_put(mesh_shape):
    dp, tp = mesh_shape
    jcfg, tcfg = _cfgs()
    jparams = jmesh.interleave_decoder_for_tp(
        synthetic_decoder(jcfg, param_dtype=jnp.float32, seed=5), jcfg, tp)
    tparams = _port(jparams)
    jm = _jax_mesh(dp, tp)
    jspecs = jmesh.decoder_shardings(jcfg, jm)
    tspecs = tmesh.decoder_shardings(tcfg)
    for d, m, view in _each_rank(dp, tp):
        got = tmesh.shard_params(tparams, tspecs, view)
        assert got["lm_head"] is got["embed"]
        for key in ("embed", "final_norm"):
            want = _jax_block(jparams[key], jm, jspecs[key].spec, d, m)
            assert np.array_equal(got[key].numpy(), want), key
        for key, leaf in got["layers"].items():
            want = _jax_block(jparams["layers"][key], jm, jspecs["layers"][key].spec, d, m)
            assert np.array_equal(leaf.numpy(), want), key
    # the batched cache: rows over "data", KV heads over "model", both leaves
    kv = np.arange(2 * 2 * 4 * 8 * 3 * 2, dtype=np.float32).reshape(2, 2, 4, 8, 3, 2)
    jspec = jmesh.batched_kv_sharding(jm).spec
    qkv = tmesh.batched_kv_sharding(None, quant=True)
    for d, m, view in _each_rank(dp, tp):
        want = _jax_block(kv, jm, jspec, d, m)
        got = tmesh.shard_tensor(torch.from_numpy(kv), tmesh.batched_kv_sharding(), view)
        assert np.array_equal(got.numpy(), want)
        pair = tmesh.shard_tensor(dec.QuantKV(torch.from_numpy(kv), torch.from_numpy(kv[..., 0])),
                                  qkv.q, view)
        assert np.array_equal(pair.s.numpy(), want[..., 0])
        act = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
        assert np.array_equal(
            tmesh.shard_tensor(torch.from_numpy(act), tmesh.batch_sharding(None, 2), view).numpy(),
            _jax_block(act, jm, jmesh.batch_sharding(jm, 2).spec, d, m))


def test_head_keys_reduce_to_the_argmax():
    """Packed keys of each vocabulary shard, reduced by MAX, give the
    single-device argmax: a tie across the shard boundary goes to the lower
    index, negative logits order correctly, -0 equals +0."""
    V, H, R, n = 64, 16, 5, 2
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((V, H)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    w[V // 2] = w[V // 2 - 1]                    # a tie across the boundary
    h[0] = w[V // 2] * 10.0                      # ... that row 0 picks
    w_neg = -w.abs() - 0.5                       # every logit of h[1] below zero
    h[1] = torch.from_numpy(np.abs(rng.standard_normal(H)).astype(np.float32))
    w_zero = torch.zeros((V, H))                 # +-0 logits: index 0 wins
    w_zero[V // 2 + 3] = -0.0
    for table in (w, w_neg, w_zero):
        want = am.argmax_matvec_plain(h, table)
        parts = [am.argmax_matvec(h, table[r * V // n : (r + 1) * V // n], offset=r * V // n)
                 for r in range(n)]
        got = am.key_index(torch.stack(parts).max(dim=0).values)
        assert torch.equal(got, want)
    assert int(am.argmax_matvec_plain(h[:1], w)[0]) == V // 2 - 1


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_tp_default(n):
    assert tmesh.default_tp(n) == jmesh.make_mesh(n).shape["model"]


@pytest.mark.parametrize("option", ["q8", "moe_offload"])
def test_shard_engine_refuses_q8_and_offload(option):
    """As in the JAX package, whose shard_params cannot place a QuantW and
    whose batched forwards read host-offloaded experts: one line each."""
    eng = SimpleNamespace(q8=False, moe_offload=False)
    setattr(eng, option, True)
    with pytest.raises(ValueError) as err:
        tmesh.shard_engine(eng, SimpleNamespace(shape={"data": 1, "model": 2}))
    assert "\n" not in str(err.value)


def test_single_stream_paths_refuse_a_tp_engine(tiny_model_dir):
    """The single-stream paths are not tensor-parallel: an engine on a tp 2
    mesh refuses them with one line, before any weight is read."""
    from smolvision_tpu_torch.runtime.engine import Engine
    from smolvision_tpu_torch.runtime.segment import transcribe_audio

    eng = Engine(tiny_model_dir, param_dtype=torch.float32, kv_dtype=torch.float32,
                 device="cpu")
    eng.max_tokens = eng.thinker_max_tokens = 4
    eng.serving_mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    samples = np.zeros(16000, np.float32)
    for run in (lambda: transcribe_audio(eng, samples), lambda: eng.transcribe_segment(samples),
                lambda: eng.thinker_generate(None, "hi")):
        with pytest.raises(ValueError, match="not tensor-parallel") as err:
            run()
        assert "\n" not in str(err.value)
    eng.serving_mesh = SimpleNamespace(shape={"data": 2, "model": 1})   # dp only: replicated
    assert isinstance(transcribe_audio(eng, samples), str)
