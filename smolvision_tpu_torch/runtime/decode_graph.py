"""The greedy decode loop on the device: one step, captured as a CUDA graph
and replayed per token.

Port of the JAX package's device loops: `Engine._decode_chunk`
(smolvision_tpu/runtime/engine.py, a jitted `lax.while_loop` of up to
DECODE_CHUNK greedy steps) and `batched_decode_chunk`
(smolvision_tpu/models/qwen3_decoder.py, the same for a batch).  PyTorch
runs eagerly; the nearest form of a compiled device loop is a CUDA graph of
one step, replayed:

  * the loop's state lives in static device tensors: the current tokens,
    the cache row `pos`, the step index `i`, the chunk's token buffer and
    the rows' EOS flags.  One step -- the decoder forward, the greedy head
    and the bookkeeping in `_step` -- reads and writes only those and the
    cache, never the host, so it is captured once per (parameters, cache
    tensor, batch) and replayed for every token;
  * a step taken after every row is done changes nothing the host reads:
    the index, the position, the tokens and the buffer advance only while
    some row is live (the while_loop's condition), so a chunk's count is
    the reference's even when the host replays past its end;
  * the host reads once per chunk (the count and the buffer).  It learns
    that the chunk ended from a pinned copy of the all-done flag, polled
    DONE_LAG replays behind the last one enqueued, so the card never waits
    on the host, and at most DONE_LAG - 1 replays run after the end
    (`PerfStats.wasted_steps` counts them);
  * the first step of a new graph runs eagerly on the capture stream: it
    is a real step, and the warm-up that capture needs (library loads,
    ctypes bindings, the kernels' one-time attributes);
  * each kernel wrapper counts its launches on the host, which a replay
    does not run: the counts a capture adds are taken back and added again
    on every replay (`StepGraph`), so `ffi.launch_counts` stays the number
    of launches.

On the CPU (the tests, SMOLVISION_PLATFORM=cpu) the same step runs
eagerly and the loop reads the flags after every step.  A loop holds its
cache tensor, which its graph writes into: its owner makes a new loop when
it replaces the cache.  A failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import time

import torch

from smolvision_tpu_torch.config import EOS_TOKEN_IDS
from smolvision_tpu_torch.kernels import ffi

DECODE_CHUNK = 64   # steps per host read, as the JAX engine's
DONE_LAG = 3        # replays in flight past the one whose flag the host reads


def capture(step, stream):
    """The replay of `step`: a CUDA graph of it captured on `stream`; on the
    CPU (stream None) the step itself, run eagerly."""
    if stream is None:
        return step
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        step()
    return graph.replay


class StepGraph:
    """One step captured for replay, with the kernel launches one replay
    makes (`launches`, by `ffi.launch_counts` key)."""

    def __init__(self, step, stream):
        before = dict(ffi.launch_counts)
        self._replay = capture(step, stream)
        self.launches = {k: ffi.launch_counts[k] - n for k, n in before.items()
                         if ffi.launch_counts[k] != n}
        ffi.launch_counts.update(before)

    def replay(self) -> None:
        self._replay()
        for k, n in self.launches.items():
            ffi.launch_counts[k] += n


class DecodeLoop:
    """A greedy decode loop of B rows on one cache, its state on the device.

    `forward(tokens, pos, **inputs)` is one decoder step on the cache `kv`
    of `capacity` rows: tokens int32 [B], pos int64 [1] -> the next tokens,
    int32 [B].  `inputs` (name -> a tensor of its shape and type) are the
    step's other static tensors, which `run` refreshes before each chunk.
    `perf` (a PerfStats, or None) counts the captures and the wasted
    steps."""

    def __init__(self, forward, batch: int, kv, capacity: int, device, perf, inputs=None):
        dev = torch.device(device)
        self.forward = forward
        self.kv = kv
        self.capacity = capacity
        self.perf = perf
        self.inputs = {k: torch.zeros_like(v, device=dev) for k, v in (inputs or {}).items()}
        self.tok = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        self.buf = torch.zeros((batch, DECODE_CHUNK), dtype=torch.int32, device=dev)
        self.done = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.stop = torch.zeros(1, dtype=torch.bool, device=dev)
        self.eos = torch.tensor(sorted(EOS_TOKEN_IDS), dtype=torch.int32, device=dev)
        self.graph = None
        self.stream = None
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)
            self.flag = torch.zeros(1, dtype=torch.bool, pin_memory=True)
            self.events = [torch.cuda.Event() for _ in range(DONE_LAG)]

    def _step(self) -> None:
        live = ~self.stop
        nxt = self.forward(self.tok, self.pos, **self.inputs)
        kept = self.buf.index_select(1, self.i)[:, 0]
        self.buf.index_copy_(1, self.i, torch.where(live, nxt, kept)[:, None])
        self.done |= (nxt[:, None] == self.eos[None, :]).any(-1)
        self.tok.copy_(torch.where(live, nxt, self.tok))
        self.i += live
        self.pos += live
        self.stop.copy_(self.done.all().reshape(1))

    def _advance(self) -> None:
        """One step: a replay of the graph, or, before there is one, the
        step run eagerly on the capture stream and then captured."""
        if self.graph is not None:
            self.graph.replay()
            return
        ctx = contextlib.nullcontext()
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream())
            ctx = torch.cuda.stream(self.stream)
        with ctx:
            self._step()
            t0 = time.monotonic()
            self.graph = StepGraph(self._step, self.stream)
            if self.stream is not None:
                torch.cuda.current_stream().wait_stream(self.stream)
                if self.perf is not None:
                    self.perf.graph_captures += 1
                    self.perf.graph_capture_ms += (time.monotonic() - t0) * 1000.0

    @torch.inference_mode()
    def run(self, tokens, pos: int, steps: int, row_active=None, **inputs):
        """Up to `steps` (<= DECODE_CHUNK) greedy steps of every row from
        `tokens` [B] at cache row `pos`, stopping once every row has emitted
        an EOS (rows that finish first decode on; the caller cuts them at
        their EOS).  row_active [B] bool marks rows done from the start.
        Returns (buf, count, replays): the tokens [B, count] as numpy int32,
        the steps the reference's loop would run, and the steps run."""
        if not 0 < steps <= DECODE_CHUNK:
            raise ValueError(f"a chunk takes 1..{DECODE_CHUNK} steps, not {steps}")
        if not 0 <= pos <= self.capacity - steps:
            # the device never checks its position: this is where it is checked
            raise ValueError(f"cache rows {pos}..{pos + steps} past its {self.capacity}")
        if isinstance(tokens, int):
            self.tok.fill_(tokens)
        else:
            self.tok.copy_(torch.as_tensor(tokens).reshape(self.tok.shape))
        self.pos.fill_(int(pos))
        self.i.zero_()
        self.buf.zero_()
        done = (self.tok[:, None] == self.eos[None, :]).any(-1)
        if row_active is not None:
            done |= ~torch.as_tensor(row_active, device=self.done.device)
        self.done.copy_(done)
        self.stop.copy_(done.all().reshape(1))
        for name, value in inputs.items():
            self.inputs[name].copy_(torch.as_tensor(value))
        replays = self._run_cuda(steps) if self.stream is not None else self._run_cpu(steps)
        count = int(self.i)
        buf = self.buf[:, :count].cpu().numpy()
        if self.perf is not None:
            self.perf.wasted_steps += replays - count
        return buf, count, replays

    def _run_cpu(self, steps: int) -> int:
        n = 0
        while n < steps and not bool(self.stop):
            self._advance()
            n += 1
        return n

    def _run_cuda(self, steps: int) -> int:
        self.flag.zero_()
        n = 0
        while n < steps:
            if n >= DONE_LAG:
                self.events[n % DONE_LAG].synchronize()
                if bool(self.flag[0]):
                    break
            self._advance()
            self.flag.copy_(self.stop, non_blocking=True)
            self.events[n % DONE_LAG].record()
            n += 1
        return n
