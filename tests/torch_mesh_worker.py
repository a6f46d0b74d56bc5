"""One rank of the port's mesh runs (tests/test_torch_mesh_dist.py, the
two-rank card test of tests/test_torch_cuda.py and phase 13 of
chip_smoke.py, which load this file by its path: a host may have another
top-level `tests` package).

    PYTHONPATH=. python tests/torch_mesh_worker.py SPEC.json RANK WORLD STORE OUT

joins a `gloo` process group of WORLD ranks that meet through the file
STORE (a torch.distributed FileStore), runs
every case of SPEC in order on SPEC's device (each case builds its engine,
its (dp, tp) mesh and its inputs) and pickles {case name: result} to
OUT.RANK.  It imports the port only: the JAX references are computed by
the test that starts it.  Inputs too large for the JSON (audio, weights)
come in the .npz files SPEC names.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from smolvision_tpu_torch.config import EOS_TOKEN_IDS
from smolvision_tpu_torch.kernels import ffi
from smolvision_tpu_torch.ops.collectives import gather_host
from smolvision_tpu_torch.parallel import batch as pbatch
from smolvision_tpu_torch.parallel import mesh as mesh_mod
from smolvision_tpu_torch.runtime import batch_segments as bs
from smolvision_tpu_torch.runtime import multistream as ms
from smolvision_tpu_torch.runtime import serving
from smolvision_tpu_torch.runtime import stream as stream_mod
from smolvision_tpu_torch.runtime.decode_graph import DecodeLoop
from smolvision_tpu_torch.runtime.engine import Engine

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_ranks(spec: dict, workdir: str, world: int = 2):
    """Start `world` rank processes of tests/torch_mesh_worker.py on spec."""
    path = os.path.join(workdir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    # the ranks meet through a file (a port picked here could be taken
    # before rank 0 binds it)
    store = os.path.join(workdir, f"rendezvous-{os.getpid()}-{time.monotonic_ns()}")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, str(rank), str(world),
             store, os.path.join(workdir, "out")],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_ranks(procs, workdir: str, limit_s: float):
    """Wait for the ranks within limit_s in all; kill every rank on a hang
    or a failure and fail with the ranks' logs.  Returns each rank's results."""
    deadline = time.monotonic() + limit_s
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs is None or any(rcs):
        logs = "".join(open(os.path.join(workdir, f"rank{r}.log")).read()[-3000:]
                       for r in range(len(procs)))
        raise AssertionError(f"mesh ranks {'timed out' if rcs is None else f'exited {rcs}'}:"
                             f"\n{logs}")
    out = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"out.{r}"), "rb") as f:
            out.append(pickle.load(f))
    return out


_ENGINES = {}   # the last engine, by its settings: consecutive cases share it


def engine(case: dict, device: str, mesh=None) -> Engine:
    """The case's engine on `mesh` when given, its settings applied: the
    previous case's when it was built the same way (its counters reset)."""
    key = json.dumps([case.get(k) for k in ("model", "dtype", "kv8", "mesh")])
    eng = _ENGINES.get(key)
    if eng is None:
        _ENGINES.clear()
        dt = DTYPES[case.get("dtype", "f32")]
        eng = Engine(case["model"], param_dtype=dt, kv_dtype=dt, device=device,
                     kv8=case.get("kv8", False))
        if mesh is not None:
            mesh_mod.shard_engine(eng, mesh)
        _ENGINES[key] = eng
    eng.perf.reset()
    for name, value in case.get("settings", {}).items():
        setattr(eng, name, value)
    assert eng.set_force_language(case.get("language"))
    return eng


def audio(case: dict):
    with np.load(case["audio"]) as f:
        return [f[k] for k in sorted(f.files, key=lambda k: int(k))]


def counters(eng: Engine) -> dict:
    """The run's kernel launches and the engine's counters (PerfStats)."""
    return {"launches": dict(ffi.launch_counts),
            "perf": {k: v for k, v in vars(eng.perf).items() if isinstance(v, (int, float))}}


def run_serve(case, device, mesh):
    eng = engine(case, device, mesh)
    ffi.reset_launch_counts()
    rows = serving.decode_continuous(eng, audio(case), slots=case["slots"])
    texts = [bs.gate_text(eng, row) for row in rows]
    return {"texts": texts, "rows": rows, **counters(eng)}


def run_segments(case, device, mesh):
    eng = engine(case, device, mesh)
    ffi.reset_launch_counts()
    rows = bs.decode_segments_batched(eng, audio(case))
    texts = [bs.gate_text(eng, row) for row in rows]
    return {"texts": texts, "rows": rows, "text_tokens": eng.perf.text_tokens, **counters(eng)}


def run_multistream(case, device, mesh):
    eng = engine(case, device, mesh)
    log = []
    finish = stream_mod.StreamState.finish_chunk

    def spy(state, w, chunk_tokens, *args):
        log.append(list(chunk_tokens))
        return finish(state, w, chunk_tokens, *args)

    stream_mod.StreamState.finish_chunk = spy
    try:
        ffi.reset_launch_counts()
        texts = ms.run_streams_batched(eng, audio(case))
    finally:
        stream_mod.StreamState.finish_chunk = finish
    record = eng.perf.multistream
    return {"texts": texts, "chunks": log, "rounds": record["rounds"],
            "compactions": record["compactions"], **counters(eng)}


def run_encode(case, device, mesh):
    """The group encode under the encoder's SP: the host mel, or with
    "device_mel" the device front end (each rank packs its share)."""
    from smolvision_tpu_torch.ops.mel import log_mel

    eng = engine(case, device, mesh)
    clips = audio(case)
    if case.get("device_mel"):
        stack, n_tokens = bs._encode_batch_device_mel(eng, clips)
    else:
        stack, n_tokens = bs._encode_batch(eng, [log_mel(a) for a in clips])
    return {"stack": stack.cpu().numpy(), "n_tokens": n_tokens}


def run_tp_chunk(case, device, mesh):
    """One batched prefill and a decode chunk on the decoder of the JAX
    package's test_tp.py (its params, interleaved and sharded here)."""
    from smolvision_tpu_torch.config import QWEN3_ASR_06B
    import dataclasses

    cfg = dataclasses.replace(QWEN3_ASR_06B, **case["cfg"])
    with np.load(case["params"]) as f:
        flat = {k: torch.from_numpy(f[k]).to(device) for k in f.files}
    params = {"embed": flat["embed"], "final_norm": flat["final_norm"],
              "layers": {k[7:]: v for k, v in flat.items() if k.startswith("layers.")}}
    params["lm_head"] = params["embed"]
    params = mesh_mod.interleave_decoder_for_tp(params, cfg, mesh_mod.mesh_tp(mesh))
    params = mesh_mod.shard_params(params, mesh_mod.decoder_shardings(cfg, mesh), mesh)
    group = mesh.group(mesh_mod.MODEL_AXIS)
    with np.load(case["audio"]) as f:
        embeds = torch.from_numpy(f["embeds"]).to(device)
    B, T, _ = embeds.shape
    rows = mesh.rows(B)
    kv = pbatch.make_batched_kv(cfg, rows.stop - rows.start, case["kcap"], torch.float32,
                                device, group)
    with torch.inference_mode():
        tokens, kv = pbatch.batched_prefill(params, cfg, embeds[rows], kv, group=group)
        buf, count, _, _ = pbatch.batched_decode_chunk(params, cfg, tokens, T, kv,
                                                       case["steps"], group=group)
    dg = mesh.group(mesh_mod.DATA_AXIS)
    return {"tokens": gather_host(tokens.cpu().numpy(), dg).reshape(-1),
            "buf": gather_host(buf.numpy(), dg).reshape(B, -1), "count": count}


def run_loop_eos(case, device, mesh):
    """A decode loop whose rows emit an EOS at set steps (`stop_at`, one
    per global row): this rank's rows end at their own steps, the chunk's
    count is every rank's."""
    eos = sorted(EOS_TOKEN_IDS)[0]
    stop_at = torch.tensor(case["stop_at"], dtype=torch.int64, device=device)[mesh.rows(
        len(case["stop_at"]))]
    base = 1000 * (1 + torch.arange(len(case["stop_at"]), device=device))[mesh.rows(
        len(case["stop_at"]))]

    def forward(tok, pos):
        step = pos - case["pos"]
        return torch.where(step >= stop_at, eos, base + step).to(torch.int32)

    loop = DecodeLoop(forward, stop_at.shape[0], None, 4096, device, None,
                      data_group=mesh.group(mesh_mod.DATA_AXIS))
    buf, count, replays = loop.run(torch.zeros(stop_at.shape[0], dtype=torch.int32),
                                   case["pos"], case["steps"])
    return {"buf": buf, "count": count, "replays": replays, "tokens_h": loop.tokens_h}


RUNNERS = {"serve": run_serve, "segments": run_segments, "multistream": run_multistream,
           "encode": run_encode, "tp_chunk": run_tp_chunk, "loop_eos": run_loop_eos}


def main(argv) -> int:
    spec_path, rank, world, store, out = argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 2))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    device = spec.get("device", "cpu")
    results = {}
    meshes = {}
    for case in spec["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = mesh_mod.make_mesh(tp=shape[1], device=device)
        assert mesh_mod.mesh_dp(meshes[shape]) == shape[0]
        t0 = time.monotonic()
        results[case["name"]] = RUNNERS[case["kind"]](case, device, meshes[shape])
        results[case["name"]]["seconds"] = time.monotonic() - t0
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
