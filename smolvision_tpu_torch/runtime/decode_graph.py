"""The device-side loops of the single-stream and batched decoders: one step,
captured as a CUDA graph and replayed.

Port of the JAX package's compiled device programs: `Engine._decode_chunk`
(smolvision_tpu/runtime/engine.py, a jitted `lax.while_loop` of up to
DECODE_CHUNK greedy steps), `batched_decode_chunk`
(smolvision_tpu/models/qwen3_decoder.py, the same for a batch),
`Engine._get_spec_chunk` (--spec: a jitted `while_loop` of draft, verify and
accept), `sample_chunk` (the thinker's sampled `while_loop`),
`_prefill_greedy` (prefill jit-compiled once per bucket), multistream's
`prefill_delta_j` (the round's batched delta prefill, compiled once per
block width with its start traced) and serving's admission wave
(`serving_build_embeds` + `serving_group_prefill`, once per wave shape).
PyTorch runs eagerly; the nearest form of a compiled device program is a
CUDA graph of one step, replayed:

  * the state lives in static device tensors: for a loop the current
    tokens, the cache row `pos`, the step index, the chunk's token buffer
    and the rows' EOS flags; for a prefill its embeddings, start and valid
    length (a batched round prefill: its rows' rope starts, left pads,
    last rows and natural-layout masks).  One step -- a decoder forward,
    the greedy head and the bookkeeping in `_step` -- reads and writes only
    those and the cache, never the host, so it is captured once per
    (parameters, cache tensor, shape) and replayed;
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

On a mesh (parallel/mesh.py) a batched loop holds its data rank's rows and
its chunk's host read is all-gathered over "data", so the count, the done
rows and the tokens are every rank's; a step that holds collectives (tp >
1) runs eagerly, never captured.

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
from smolvision_tpu_torch.ops.collectives import gather_host
from smolvision_tpu_torch.runtime import sampling

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
    owner ("decode", "spec", "sample", "prefill", "delta_prefill" or
    "wave")."""

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
    a capture stream (the card; its own unless `stream` is given: owners
    whose graphs run one at a time may share one) and replayed."""

    kind = "decode"

    def __init__(self, device, perf, stream=None):
        self.perf = perf
        self.graph = None
        dev = torch.device(device)
        self.stream = stream
        if stream is None and dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)

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

    def _replays(self, steps: int, shadow=None) -> int:
        """Up to `steps` steps, stopping at the stop flag; the steps run.
        `shadow()`, host work of the caller's, runs once while the card has
        replays queued: before the host first waits on one (after all of
        them on the CPU)."""
        n = 0
        if self.stream is None:
            while n < steps and not bool(self.stop):
                self._advance()
                n += 1
        else:
            self.flag.zero_()
            while n < steps:
                if n >= DONE_LAG:
                    if shadow is not None:
                        shadow()
                        shadow = None
                    self.events[n % DONE_LAG].synchronize()
                    if bool(self.flag[0]):
                        break
                self._advance()
                self.flag.copy_(self.stop, non_blocking=True)
                self.events[n % DONE_LAG].record()
                n += 1
        if shadow is not None:
            shadow()
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
    steps.

    On a mesh (parallel/mesh.py) the B rows are this data rank's.  With
    `data_group` the chunk's host read is global: every rank's counters,
    last tokens and buffer in one all_gather, the count the largest (the
    step at which the last live row of all ranks ended: a rank whose rows
    ended sooner has replayed only steps that change nothing), so every
    rank takes the same host decisions.  `eager` runs every step eagerly,
    never captured: a step with collectives (tp > 1) is not captured."""

    def __init__(self, forward, batch: int, kv, capacity: int, device, perf, inputs=None,
                 data_group=None, eager: bool = False):
        super().__init__(kv, capacity, device, perf)
        self.data_group = data_group
        self.eager = eager
        self.tokens_h = None   # the last tokens of every row after a chunk (numpy int32)
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

    def _advance(self) -> None:
        if not self.eager:
            super()._advance()
            return
        with self._on_stream():
            self._step()

    @torch.inference_mode()
    def run(self, tokens, pos: int, steps: int, row_active=None, shadow=None, **inputs):
        """Up to `steps` (<= DECODE_CHUNK) greedy steps of every row from
        `tokens` [B] at cache row `pos`, stopping once every row has emitted
        an EOS (rows that finish first decode on; the caller cuts them at
        their EOS).  row_active [B] bool marks rows done from the start;
        `shadow` is host work run while the steps are queued (`_replays`).
        Returns (buf, count, replays): the tokens [B, count] as numpy int32
        (every data rank's rows under a data group), the steps the
        reference's loop would run, and the steps run here.  `tokens_h`
        then holds the rows' last tokens."""
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
        replays = self._replays(steps, shadow)
        (count,), host = self._read(torch.cat([self.tok[:, None], self.buf], dim=1), self.i)
        if self.perf is not None:
            self.perf.wasted_steps += replays - count
        if self.data_group is not None:
            parts = gather_host(np.concatenate([[count], host.reshape(-1)]).astype(np.int32),
                                self.data_group, self.tok.device)
            count = int(parts[:, 0].max())
            host = parts[:, 1:].reshape(-1, host.shape[1])
        self.tokens_h = host[:, 0].copy()
        return host[:, 1 : 1 + count], count, replays


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


class SampleLoop(_ChunkLoop):
    """The thinker's sampled decode loop (the JAX engine's `sample_chunk`)
    on one cache, its state on the device; one replay is one sampled step.

    `forward(tok, pos)` is one decoder step at cache row pos (int64 [1])
    from tok (int32 [1]) -> the logits [V], f32.  A step observes the
    current token in the repetition window (`recent`, a ring of REP_WINDOW
    ids, `n_recent` observed so far), runs `forward`, transforms the logits
    (`sampling.transform_logits`: penalty, temperature, the static top_k)
    and draws (`sampling.draw`, keyed by seed and the cache row), then
    writes the token under the live mask and stops after an EOS.  The
    window advances only while live, so it carries over to the next chunk
    exactly; temperature, penalty and seed are device scalars that `run`
    refreshes, so one loop serves every setting of one top_k."""

    kind = "sample"

    def __init__(self, forward, top_k: int, kv, capacity: int, device, perf):
        super().__init__(kv, capacity, device, perf)
        dev = torch.device(device)
        self.forward = forward
        self.top_k = int(top_k)
        self.tok = torch.zeros(1, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        self.buf = torch.zeros(DECODE_CHUNK, dtype=torch.int32, device=dev)
        self.done = torch.zeros(1, dtype=torch.bool, device=dev)
        self.recent = torch.zeros(sampling.REP_WINDOW, dtype=torch.int32, device=dev)
        self.n_recent = torch.zeros(1, dtype=torch.int64, device=dev)
        self.temp = torch.zeros((), dtype=torch.float32, device=dev)
        self.penalty = torch.zeros((), dtype=torch.float32, device=dev)
        self.seed = torch.zeros(1, dtype=torch.int64, device=dev)

    def _step(self) -> None:
        live = ~self.stop
        slot = self.n_recent % self.recent.shape[0]
        kept = self.recent.index_select(0, slot)
        self.recent.index_copy_(0, slot, torch.where(live, self.tok, kept))
        self.n_recent += live
        logits = self.forward(self.tok, self.pos)
        logits = sampling.transform_logits(logits, self.recent, self.n_recent, self.penalty,
                                           self.temp, self.top_k)
        nxt = sampling.draw(logits, self.seed, self.pos)
        kept = self.buf.index_select(0, self.i)
        self.buf.index_copy_(0, self.i, torch.where(live, nxt, kept))
        self.done |= (nxt[:, None] == self.eos[None, :]).any(-1)
        self.tok.copy_(torch.where(live, nxt, self.tok))
        self.i += live
        self.pos += live
        self.stop.copy_(self.done)

    @torch.inference_mode()
    def run(self, token: int, pos: int, steps: int, recent: torch.Tensor,
            n_recent: torch.Tensor, temp: float, penalty: float, seed: int):
        """Up to `steps` (<= DECODE_CHUNK) sampled steps from `token` at
        cache row `pos`, stopping after an EOS (counted).  recent
        [REP_WINDOW] int32 and n_recent int64 [1] are the caller's
        repetition window on the device, read before the chunk and written
        back after it (device copies).  Returns (buf, count, replays) as
        DecodeLoop.run does (buf [1, count])."""
        self._check(pos, steps, steps)
        self.tok.fill_(int(token))
        self.pos.fill_(int(pos))
        self.i.zero_()
        self.buf.zero_()
        self.done.zero_()
        self.stop.zero_()
        self.recent.copy_(recent)
        self.n_recent.copy_(n_recent)
        self.temp.fill_(float(temp))
        self.penalty.fill_(float(penalty))
        self.seed.fill_(int(seed))
        replays = self._replays(steps)
        recent.copy_(self.recent)
        n_recent.copy_(self.n_recent)
        (count,), buf = self._read(self.buf, self.i)
        if self.perf is not None:
            self.perf.wasted_steps += replays - count
        return buf[None, :count], count, replays


class _Prefill(_Captured):
    """What the prefill graphs share: the embeddings block and the start in
    static device tensors, the greedy tokens of `rows` rows out, and the
    calls: the first runs eagerly on the capture stream, the second is
    captured and replayed, later ones replay -- a one-shot cache (offline,
    a sequential segment) never pays a capture, recurring blocks replay.
    With `warm` False (a shared capture stream that an earlier graph's
    first run warmed, its owner having run the block eagerly) the first
    call is captured."""

    kind = "prefill"

    def __init__(self, forward, embeds: torch.Tensor, rows: int, perf, stream=None,
                 warm: bool = True):
        super().__init__(embeds.device, perf, stream)
        self.warm = warm
        dev = embeds.device
        self.forward = forward
        self.embeds = torch.zeros_like(embeds)
        self.start = torch.zeros(1, dtype=torch.int64, device=dev)
        self.tok = torch.zeros(rows, dtype=torch.int32, device=dev)
        self.calls = 0

    def _note_capture(self, ms: float) -> None:
        self.perf.prefill_captures += 1
        self.perf.prefill_capture_ms += ms

    def _call(self, embeds: torch.Tensor, start: int) -> None:
        """One prefill of `embeds` at cache row `start`, the other inputs
        already in their static tensors; the tokens are left in `tok`."""
        self.embeds.copy_(embeds)
        self.start.fill_(int(start))
        if self.graph is None:
            with self._on_stream():
                if self.calls or not self.warm:
                    self._capture()
                else:
                    self._step()
        if self.graph is not None:
            self.graph.replay()
            if self.perf is not None:
                self.perf.prefill_replays += 1
        self.calls += 1


class PrefillGraph(_Prefill):
    """A greedy prefill of a block of T rows on one cache, at a device start
    (the JAX engine's `_prefill_greedy`, compiled once per bucket).

    `forward(embeds, start, valid)` is the prefill: embeds [T, H] written at
    cache rows start.. (int64 [1]), valid (int64 [1]) of them real -> the
    greedy token of row valid - 1, int32 [1]."""

    def __init__(self, forward, embeds: torch.Tensor, perf):
        super().__init__(forward, embeds, 1, perf)
        self.valid = torch.zeros(1, dtype=torch.int64, device=embeds.device)

    def _step(self) -> None:
        self.tok.copy_(self.forward(self.embeds, self.start, self.valid).reshape(1))

    @torch.inference_mode()
    def run(self, embeds: torch.Tensor, start: int, valid: int) -> torch.Tensor:
        """The greedy token (int32, 0-dim) of prefilling `embeds` at cache
        row `start` with `valid` real rows; the caller has checked the rows
        against the cache."""
        self.valid.fill_(int(valid))
        self._call(embeds, start)
        return self.tok[0].clone()


class BatchedPrefillGraph(_Prefill):
    """Multistream's round prefill: a delta block of W rows of each of B
    cache rows at a batch-uniform device start (the JAX package's
    `prefill_delta_j`, compiled once per block width with the start
    traced), one graph per (cache, B, W).

    `forward(embeds, start, **inputs)` is the greedy delta prefill: embeds
    [B, W, H] written at cache rows start.. (int64 [1]) -> the round's first
    tokens, int32 [B].  `inputs` (name -> a tensor of its shape and type)
    are its other static tensors, which `run` refreshes before each call."""

    kind = "delta_prefill"

    def __init__(self, forward, embeds: torch.Tensor, inputs, perf, stream=None,
                 warm: bool = True):
        super().__init__(forward, embeds, embeds.shape[0], perf, stream, warm)
        self.inputs = {k: torch.zeros_like(v, device=embeds.device) for k, v in inputs.items()}

    def _step(self) -> None:
        self.tok.copy_(self.forward(self.embeds, self.start, **self.inputs))

    @torch.inference_mode()
    def run(self, embeds: torch.Tensor, start: int, **inputs) -> torch.Tensor:
        """The first tokens (int32 [B], on the device) of prefilling
        `embeds` at cache row `start`; the caller has checked the rows
        against the cache."""
        for name, value in inputs.items():
            self.inputs[name].copy_(torch.as_tensor(value))
        self._call(embeds, start)
        return self.tok.clone()


class WaveGraph(_Prefill):
    """Serving's admission wave: the JAX package's `serving_build_embeds`
    and `serving_group_prefill` (compiled once per shape, the small cache
    donated) as one step, one graph per (Gcap, acap) on a small cache
    that its owner pools.

    `forward(audio, start, ids, audio_start, audio_len, last_rows,
    prompt_max)` builds the wave's embeddings from the token ids [Gcap,
    pcap] (int64) and the encoded audio [Gcap, acap, H] and delta-prefills
    them at the device start -> the greedy first tokens, int32 [Gcap]; the
    four row inputs are int32 [Gcap].  The audio is the block that `run`
    copies into its static tensor, and the integers travel in one copy
    from pinned memory that never waits for the card, so a wave dispatched
    while a decode chunk runs stays behind it."""

    kind = "wave"

    def __init__(self, forward, audio: torch.Tensor, pcap: int, perf):
        super().__init__(forward, audio, audio.shape[0], perf)
        self.ints = torch.zeros((audio.shape[0], pcap + 4), dtype=torch.int64,
                                device=audio.device)

    def _step(self) -> None:
        pcap = self.ints.shape[1] - 4
        rows = self.ints[:, pcap:].t().to(torch.int32).contiguous()
        self.tok.copy_(self.forward(self.embeds, self.start, self.ints[:, :pcap], *rows))

    @torch.inference_mode()
    def run(self, audio: torch.Tensor, ints: np.ndarray) -> torch.Tensor:
        """Dispatch the wave of `audio` [Gcap, acap, H] at start 0; `ints`
        [Gcap, pcap + 4] int64 holds each row's token ids, then its audio
        start, audio length, last prompt row and prompt length.  Returns the
        first tokens (int32 [Gcap], on the device), not read."""
        host = torch.from_numpy(np.ascontiguousarray(ints, dtype=np.int64))
        self.ints.copy_(host.pin_memory() if self.ints.is_cuda else host, non_blocking=True)
        self._call(audio, 0)
        return self.tok.clone()
