"""The device-side loops of the single-stream and batched decoders: one step,
captured as a CUDA graph and replayed.

Port of the JAX package's compiled device programs: `Engine._decode_chunk`
(smolvision_tpu/runtime/engine.py, a jitted `lax.while_loop` of up to
DECODE_CHUNK greedy steps), `batched_decode_chunk`
(smolvision_tpu/models/qwen3_decoder.py, the same for a batch),
`Engine._get_spec_chunk` (--spec: a jitted `while_loop` of draft, verify and
accept) and `_prefill_greedy` (prefill jit-compiled once per bucket).
PyTorch runs eagerly; the nearest form of a compiled device program is a
CUDA graph of one step, replayed:

  * the state lives in static device tensors: for a loop the current
    tokens, the cache row `pos`, the step index, the chunk's token buffer
    and the rows' EOS flags; for a prefill its embeddings, start and valid
    length.  One step -- a decoder forward, the greedy head and the
    bookkeeping in `_step` -- reads and writes only those and the cache,
    never the host, so it is captured once per (parameters, cache tensor,
    shape) and replayed;
  * a loop step taken after every row is done changes nothing the host
    reads: the index, the position, the tokens and the buffer advance only
    while some row is live (the while_loop's condition), so a chunk's count
    is the reference's even when the host replays past its end;
  * a loop's host reads once per chunk (its counters and buffer, in one
    copy).  It learns that the chunk ended from a pinned copy of the stop
    flag, polled DONE_LAG replays behind the last one enqueued, so the card
    never waits on the host, and at most DONE_LAG - 1 replays run after the
    end (`PerfStats.wasted_steps` counts them);
  * before a graph is captured its step runs eagerly on the capture stream:
    a real step, and the warm-up that capture needs (library loads, ctypes
    bindings, the kernels' one-time attributes).  A loop captures after its
    first step; a prefill, whose cache a one-shot caller (offline, each
    sequential segment) fills only once, runs its first call eagerly and is
    captured on its second;
  * each kernel wrapper counts its launches on the host, which a replay
    does not run: the counts a capture adds are taken back and added again
    on every replay (`StepGraph`), so `ffi.launch_counts` stays the number
    of launches.

On the CPU (the tests, SMOLVISION_PLATFORM=cpu) the same steps run eagerly
and a loop reads its stop flag after every step.  A loop or prefill graph
holds its cache tensor, which its graph writes into: its owner makes a new
one when it replaces the cache.  A failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
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
    makes (`launches`, by `ffi.launch_counts` key) and the kind of its
    owner ("decode", "spec" or "prefill")."""

    def __init__(self, step, stream, kind: str = "decode"):
        self.kind = kind
        before = dict(ffi.launch_counts)
        self._replay = capture(step, stream)
        self.launches = {k: ffi.launch_counts[k] - n for k, n in before.items()
                         if ffi.launch_counts[k] != n}
        ffi.launch_counts.update(before)

    def replay(self) -> None:
        self._replay()
        for k, n in self.launches.items():
            ffi.launch_counts[k] += n


class _Captured:
    """A step (`_step`) on static device tensors, captured as a StepGraph on
    a capture stream of its own (the card) and replayed."""

    kind = "decode"

    def __init__(self, device, perf):
        self.perf = perf
        self.graph = None
        dev = torch.device(device)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def _step(self) -> None:
        raise NotImplementedError

    @contextlib.contextmanager
    def _on_stream(self):
        """Work on the capture stream, ordered after and before the caller's."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            yield
        torch.cuda.current_stream().wait_stream(self.stream)

    def _capture(self) -> None:
        """Capture `_step` (on the capture stream, after a real step on it)."""
        t0 = time.monotonic()
        self.graph = StepGraph(self._step, self.stream, self.kind)
        if self.stream is not None and self.perf is not None:
            self._note_capture((time.monotonic() - t0) * 1000.0)

    def _note_capture(self, ms: float) -> None:
        self.perf.graph_captures += 1
        self.perf.graph_capture_ms += ms


class _ChunkLoop(_Captured):
    """What the decode loop and the spec loop share: the stop flag, one
    step per replay (the first run eagerly, then captured), the DONE_LAG
    polling and the chunk's one host read."""

    def __init__(self, kv, capacity: int, device, perf):
        super().__init__(device, perf)
        dev = torch.device(device)
        self.kv = kv
        self.capacity = capacity
        self.stop = torch.zeros(1, dtype=torch.bool, device=dev)
        self.eos = torch.tensor(sorted(EOS_TOKEN_IDS), dtype=torch.int32, device=dev)
        if self.stream is not None:
            self.flag = torch.zeros(1, dtype=torch.bool, pin_memory=True)
            self.events = [torch.cuda.Event() for _ in range(DONE_LAG)]

    def _check(self, pos: int, steps: int, rows: int) -> None:
        if not 0 < steps <= DECODE_CHUNK:
            raise ValueError(f"a chunk takes 1..{DECODE_CHUNK} steps, not {steps}")
        if not 0 <= pos <= self.capacity - rows:
            # the device never checks its position: this is where it is checked
            raise ValueError(f"cache rows {pos}..{pos + rows} past its {self.capacity}")

    def _advance(self) -> None:
        """One step: a replay of the graph, or, before there is one, the
        step run eagerly on the capture stream and then captured."""
        if self.graph is not None:
            self.graph.replay()
            return
        with self._on_stream():
            self._step()
            self._capture()

    def _replays(self, steps: int) -> int:
        """Up to `steps` steps, stopping at the stop flag; the steps run."""
        n = 0
        if self.stream is None:
            while n < steps and not bool(self.stop):
                self._advance()
                n += 1
            return n
        self.flag.zero_()
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

    @staticmethod
    def _read(buf: torch.Tensor, *counters: torch.Tensor):
        """The chunk's host read, in one copy: the counters as ints and the
        whole buffer as numpy int32."""
        host = torch.cat([c.reshape(-1).long() for c in counters]
                         + [buf.reshape(-1).long()]).cpu().numpy()
        n = len(counters)
        return [int(x) for x in host[:n]], host[n:].astype(np.int32).reshape(buf.shape)


class DecodeLoop(_ChunkLoop):
    """A greedy decode loop of B rows on one cache, its state on the device.

    `forward(tokens, pos, **inputs)` is one decoder step on the cache `kv`
    of `capacity` rows: tokens int32 [B], pos int64 [1] -> the next tokens,
    int32 [B].  `inputs` (name -> a tensor of its shape and type) are the
    step's other static tensors, which `run` refreshes before each chunk.
    `perf` (a PerfStats, or None) counts the captures and the wasted
    steps."""

    def __init__(self, forward, batch: int, kv, capacity: int, device, perf, inputs=None):
        super().__init__(kv, capacity, device, perf)
        dev = torch.device(device)
        self.forward = forward
        self.inputs = {k: torch.zeros_like(v, device=dev) for k, v in (inputs or {}).items()}
        self.tok = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        self.buf = torch.zeros((batch, DECODE_CHUNK), dtype=torch.int32, device=dev)
        self.done = torch.zeros(batch, dtype=torch.bool, device=dev)

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

    @torch.inference_mode()
    def run(self, tokens, pos: int, steps: int, row_active=None, **inputs):
        """Up to `steps` (<= DECODE_CHUNK) greedy steps of every row from
        `tokens` [B] at cache row `pos`, stopping once every row has emitted
        an EOS (rows that finish first decode on; the caller cuts them at
        their EOS).  row_active [B] bool marks rows done from the start.
        Returns (buf, count, replays): the tokens [B, count] as numpy int32,
        the steps the reference's loop would run, and the steps run."""
        self._check(pos, steps, steps)
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
        replays = self._replays(steps)
        (count,), buf = self._read(self.buf, self.i)
        if self.perf is not None:
            self.perf.wasted_steps += replays - count
        return buf[:, :count], count, replays


class SpecLoop(_ChunkLoop):
    """The --spec chunk (the JAX engine's `_get_spec_chunk`) on one cache,
    its state on the device; one replay is one speculative iteration.

    `draft(tok, pos)` is one int8 decode step: tok int32 [1] at cache row
    pos (int64 [1]) -> the draft's next token, int32 [1].  `verify(seq,
    pos)` is one full-precision forward over seq int32 [n + 1] written at
    rows pos.. (kernel B2 at a device start) with the greedy head over every
    row: g int32 [n + 1], g[i] the exact greedy successor of the prefix
    through row i.  An iteration drafts d_0..d_{n-1} from `tok` at pos +
    j, verifies [tok, d_0..d_{n-1}] at pos, accepts the longest prefix with
    d_i == g_i, and emits e = max(min(a + 1, eos_pos + 1, n_steps - out), 1)
    of the g's: every emitted token is a g_i, so the draft decides only how
    many positions share one verify.  The draft writes its (approximate)
    rows first and the verify overwrites rows pos..pos + n exactly, so one
    cache serves both; rows past the accepted prefix are rewritten before
    anything attends them.  The chunk stops after an emitted EOS or at
    n_steps tokens; every write sits under the live mask."""

    kind = "spec"

    def __init__(self, draft, verify, n_draft: int, kv, capacity: int, device, perf):
        super().__init__(kv, capacity, device, perf)
        dev = torch.device(device)
        self.draft = draft
        self.verify = verify
        self.n_draft = n_draft
        self.tok = torch.zeros(1, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.out = torch.zeros(1, dtype=torch.int64, device=dev)
        self.it = torch.zeros(1, dtype=torch.int64, device=dev)
        self.n_steps = torch.zeros(1, dtype=torch.int64, device=dev)
        self.done = torch.zeros(1, dtype=torch.bool, device=dev)
        # oversized, as the reference's: the last block's n + 1 tokens may
        # start at DECODE_CHUNK - 1; the host reads buf[:count]
        self.buf = torch.zeros(DECODE_CHUNK + n_draft + 1, dtype=torch.int32, device=dev)
        self.idx = torch.arange(n_draft + 1, device=dev)
        self.iterations = 0

    def _step(self) -> None:
        n = self.n_draft
        live = ~self.stop
        drafts, td = [], self.tok
        for j in range(n):
            td = self.draft(td, self.pos + j)
            drafts.append(td.reshape(1).to(torch.int32))
        d = torch.cat(drafts)
        g = self.verify(torch.cat([self.tok, d]), self.pos).reshape(n + 1).to(torch.int32)
        a = torch.cumprod((d == g[:n]).long(), 0).sum()
        is_eos = (g[:, None] == self.eos[None, :]).any(-1)
        eos_pos = torch.where(is_eos & (self.idx <= a), self.idx, n + 1).min()
        e = torch.minimum(torch.minimum(a + 1, eos_pos + 1), self.n_steps - self.out)
        e = e.clamp(min=1)                                               # [1]
        at = self.out + self.idx
        self.buf.index_copy_(0, at, torch.where(live, g, self.buf.index_select(0, at)))
        self.done |= live & (eos_pos + 1 <= e)
        self.tok.copy_(torch.where(live, g.index_select(0, e - 1), self.tok))
        step = torch.where(live, e, 0)
        self.pos += step
        self.out += step
        self.it += live
        self.stop.copy_(self.done | (self.out >= self.n_steps))

    @torch.inference_mode()
    def run(self, token: int, pos: int, steps: int):
        """Speculative iterations from `token` at cache row `pos` until
        `steps` (<= DECODE_CHUNK) tokens are emitted or one is an EOS.
        Returns (buf, count, replays) as DecodeLoop.run does (buf [1,
        count]); `iterations` holds the iterations the reference's loop
        would run."""
        self._check(pos, steps, steps + self.n_draft)
        self.tok.fill_(int(token))
        self.pos.fill_(int(pos))
        self.out.zero_()
        self.it.zero_()
        self.n_steps.fill_(steps)
        self.buf.zero_()
        self.done.zero_()
        self.stop.zero_()
        replays = self._replays(steps)
        (count, self.iterations), buf = self._read(self.buf, self.out, self.it)
        if self.perf is not None:
            self.perf.wasted_steps += replays - self.iterations
        return buf[None, :count], count, replays


class PrefillGraph(_Captured):
    """A greedy prefill of a block of T rows on one cache, at a device start
    (the JAX engine's `_prefill_greedy`, compiled once per bucket).

    `forward(embeds, start, valid)` is the prefill: embeds [T, H] written at
    cache rows start.. (int64 [1]), valid (int64 [1]) of them real -> the
    greedy token of row valid - 1, int32 [1].  The first call runs eagerly
    on the capture stream, the second is captured and replayed, later ones
    replay: a one-shot cache (offline, a sequential segment) never pays a
    capture, a stream's recurring delta buckets replay."""

    kind = "prefill"

    def __init__(self, forward, embeds: torch.Tensor, perf):
        super().__init__(embeds.device, perf)
        dev = embeds.device
        self.forward = forward
        self.embeds = torch.zeros_like(embeds)
        self.start = torch.zeros(1, dtype=torch.int64, device=dev)
        self.valid = torch.zeros(1, dtype=torch.int64, device=dev)
        self.tok = torch.zeros(1, dtype=torch.int32, device=dev)
        self.calls = 0

    def _step(self) -> None:
        self.tok.copy_(self.forward(self.embeds, self.start, self.valid).reshape(1))

    def _note_capture(self, ms: float) -> None:
        self.perf.prefill_captures += 1
        self.perf.prefill_capture_ms += ms

    @torch.inference_mode()
    def run(self, embeds: torch.Tensor, start: int, valid: int) -> torch.Tensor:
        """The greedy token (int32, 0-dim) of prefilling `embeds` at cache
        row `start` with `valid` real rows; the caller has checked the rows
        against the cache."""
        self.embeds.copy_(embeds)
        self.start.fill_(int(start))
        self.valid.fill_(int(valid))
        if self.graph is None:
            with self._on_stream():
                if self.calls:
                    self._capture()
                else:
                    self._step()
        if self.graph is not None:
            self.graph.replay()
            if self.perf is not None:
                self.perf.prefill_replays += 1
        self.calls += 1
        return self.tok[0].clone()
