"""The engine's counters and span recorder (`PerfStats`).

A span (`PerfStats.span`) times a block of the program on the host clock
(`time.perf_counter_ns`) and keeps, per name, a count, its host ms and its
self host ms (the span less the spans opened inside it).  With
`device=True` it also records a pair of CUDA events on the current stream
of the engine's card; `settle_mel` waits for the pairs recorded since the
last settle and adds each pair's device ms to its name.  No span
synchronises the host at its own end.

While the module's range switch is on (`profile_ranges(True)`: the CLI's
`--profile`, the benchmark's host window) each span is also a
torch.profiler range named `smolvision.<name>`, its `arg` the range's
argument (the request id: a serving wave and its clips, a stream's chunk),
so a trace holds the program's spans on the clock of the device's
kernels.  Off, a span makes no profiler call and builds no argument.

Names are `<layer>.<what>`.  A `what` that starts with "wait" marks a
point where the host blocks on the device; `host_wait_ms` sums them.
PERF.md section 3 lists every span and counter and what reads it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

_ranges = False


def profile_ranges(on: bool) -> bool:
    """Turn the spans' torch.profiler ranges on or off; returns the setting
    it replaced."""
    global _ranges
    was, _ranges = _ranges, bool(on)
    return was


class SpanStat:
    """What the spans of one name added up to since the last reset."""

    __slots__ = ("count", "host_ms", "self_ms", "device_ms")

    def __init__(self):
        self.count = 0
        self.host_ms = 0.0
        self.self_ms = 0.0
        self.device_ms = 0.0


class Span:
    """One span of `PerfStats.span`, a context manager; `ms` holds its host
    ms once it has closed."""

    __slots__ = ("perf", "name", "device", "arg", "into", "record", "t0", "child_ns", "ms",
                 "_range", "_events")

    def __init__(self, perf, name, device, arg, into, record):
        self.perf = perf
        self.name = name
        self.device = device
        self.arg = arg
        self.into = into
        self.record = record
        self.child_ns = 0
        self.ms = 0.0
        self._range = None
        self._events = None

    def __enter__(self) -> "Span":
        perf = self.perf
        if _ranges:
            arg = self.arg() if callable(self.arg) else self.arg
            self._range = torch.autograd.profiler.record_function(
                "smolvision." + self.name, None if arg is None else str(arg))
            self._range.__enter__()
        if self.device and perf.device is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(perf.device))
        perf._open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self.t0
        perf = self.perf
        perf._open.pop()
        if perf._open:
            perf._open[-1].child_ns += ns
        self.ms = ns * 1e-6
        stat = perf.spans.get(self.name)
        if stat is None:
            stat = perf.spans[self.name] = SpanStat()
        stat.count += 1
        stat.host_ms += self.ms
        stat.self_ms += (ns - self.child_ns) * 1e-6
        if self._events is not None:
            start, end = self._events
            end.record(torch.cuda.current_stream(perf.device))
            perf._pending.append((self.name, start, end, self.into, self.record))
        elif self.into is not None:
            setattr(perf, self.into, getattr(perf, self.into) + self.ms)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class _NoSpan:
    """The span of an owner with no PerfStats: nothing recorded."""

    ms = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class PerfStats:
    """The engine's counters (the reference's stderr contract and the
    benchmark's per-layer readings) and its spans.  `device`: the engine's
    device; device spans record CUDA events only on a card."""

    def __init__(self, device=None):
        self.device = (torch.device(device) if device is not None
                       and torch.device(device).type == "cuda" else None)
        # whether the single-stream decode loop (`Engine.decode_greedy`)
        # records its device span: on while a caller that settles it runs
        # (the stream), so other callers leave no events unread
        self.decode_device = False
        # the spans open now, innermost last (kept across resets: a span
        # open when the counters reset closes into the new ones)
        self._open: List[Span] = []
        self.reset()

    def reset(self):
        self.total_ms = 0.0
        self.text_tokens = 0
        self.audio_ms = 0.0
        self.encode_ms = 0.0   # mel + encoder (the reference's "encoding")
        self.decode_ms = 0.0   # prefill + decode loop (its "decoding")
        self.mel_ms = 0.0
        self.prefill_ms = 0.0
        # per span name: count, host ms, self host ms, device ms (settled)
        self.spans: Dict[str, SpanStat] = {}
        # device event pairs not yet settled: (name, start, end, the field
        # their ms goes into or None, the record whose device_ms they set or
        # None)
        self._pending: list = []
        # streaming latency (runtime/stream.py): wall ms per chunk round and
        # session-start -> first committed token (the TTFT analog)
        self.stream_chunk_ms = []
        self.stream_first_commit_ms = None
        # single-stream decode steps run (one kernel-B3 launch per layer
        # each): graph replays and eager steps, those past the end of a
        # chunk and the --spec draft steps included
        self.decode_steps = 0
        # decode steps (single and batched) run after their chunk's end
        # (runtime/decode_graph.py: the host learns of the end DONE_LAG
        # replays late); their outputs are never read
        self.wasted_steps = 0
        # CUDA graphs of a decode step (or --spec iteration) captured, and
        # the host ms they took
        self.graph_captures = 0
        self.graph_capture_ms = 0.0
        # CUDA graphs of a greedy prefill captured (one per cache and block
        # bucket, on its second call), their host ms, and the prefills
        # replayed from them
        self.prefill_captures = 0
        self.prefill_capture_ms = 0.0
        self.prefill_replays = 0
        # launches of the other kernels follow these counts, one per layer each:
        self.encodes = 0          # encoder stack calls (B1), single clips or batches
        self.prefills = 0         # single-stream prefills (B2)
        # of the prefills and decode steps, those whose output is the logits
        # (the sampled thinker's): no greedy head
        self.logits_prefills = 0
        self.logits_steps = 0
        self.reuse_prefills = 0   # of which at a cache row > 0 (streaming's KV reuse)
        self.fresh_prefills = 0   # batched fresh prefills (B4): one per length group
        self.delta_prefills = 0   # batched delta prefills (B5): one per admission wave
        self.batch_decode_steps = 0   # batched decode steps run (plain attention)
        # wall ms of the batched decode chunks; serving leaves out the host ms
        # of a wave dispatched in a chunk's shadow, which prefill_ms counts
        self.batch_decode_ms = 0.0
        # speculative decoding (--spec): verify forwards (one kernel-B2 launch
        # per layer each) and the tokens they produced (tokens / iteration is
        # the measured acceptance, at most SPEC_DRAFT + 1)
        self.spec_iters = 0
        self.spec_tokens = 0
        # continuous-serving per-clip latency (runtime/serving.py): ttft /
        # completion p50/p99 dict over the last queue, or None
        self.serving_latency = None
        # one record per serving admission wave: its rows, how it ran
        # ("eager", or a wave graph's "first" / "capture" / "replay"),
        # whether it was dispatched in a decode chunk's shadow, the host ms
        # of its dispatch and of its first tokens' read at admission, its
        # device ms once settled (None on the CPU), its clips and, per clip,
        # the ms from the call's start to its admission with its first token
        self.serving_waves = []
        # multistream's batched coordinator (runtime/multistream.py): its
        # caches, growths, compactions and one record per round, or None
        self.multistream = None

    def span(self, name: str, device: bool = False, arg=None, into: Optional[str] = None,
             record: Optional[dict] = None) -> Span:
        """A span of the block under `name` ("<layer>.<what>").  `device`:
        also its device ms (CUDA events on the current stream, settled by
        `settle_mel`).  `arg`: the profiler range's argument, or a function
        that makes it; called and made a string only while ranges are on.
        `into`: a counter field that receives the
        span's device ms when settled, or its host ms where it recorded no
        events.  `record`: a dict whose "device_ms" the settle sets."""
        return Span(self, name, device, arg, into, record)

    def device_pair(self, name: str, start, end, into: Optional[str] = None) -> None:
        """A pair of timing CUDA events recorded elsewhere (the front end's
        upload copy on a side stream), settled as a device span's."""
        self._pending.append((name, start, end, into, None))
        self.spans.setdefault(name, SpanStat()).count += 1

    def settle_mel(self) -> None:
        """Settle every device span recorded since the last settle: wait for
        its end event, add its device ms to its name, its `into` field and
        its record.  (The name is the first use's, the front end's log-mel
        events; callers and the benchmark harness call it by it.)"""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        with self.span("perf.wait_settle"):
            for name, start, end, into, record in pending:
                end.synchronize()
                ms = start.elapsed_time(end)
                self.spans.setdefault(name, SpanStat()).device_ms += ms
                if into is not None:
                    setattr(self, into, getattr(self, into) + ms)
                if record is not None:
                    record["device_ms"] = (record.get("device_ms") or 0.0) + ms

    def device_ms(self, *names: str) -> float:
        """The settled device ms of the spans of these names."""
        return sum(self.spans[n].device_ms for n in names if n in self.spans)

    @property
    def captures(self) -> int:
        """CUDA graphs captured, of every kind (decode loops, prefills,
        waves)."""
        return self.graph_captures + self.prefill_captures

    @property
    def capture_ms(self) -> float:
        """Host ms of every capture (the span graph.capture on a card)."""
        return self.graph_capture_ms + self.prefill_capture_ms

    @property
    def encode_device_ms(self) -> float:
        """Device ms of the encoder stage: serving's encode groups and the
        stream's window and tail encodes (front end included)."""
        return self.device_ms("serve.encode", "stream.encode")

    @property
    def batch_decode_device_ms(self) -> float:
        """Device ms of serving's decode chunks, less the device ms of the
        waves dispatched in a chunk's shadow."""
        return self.device_ms("serve.decode") - sum(
            w.get("device_ms") or 0.0 for w in self.serving_waves if w["shadow"])

    @property
    def decode_device_ms(self) -> float:
        """Device ms of the single-stream decode loop (`Engine.decode_greedy`)."""
        return self.device_ms("decode.loop")

    @property
    def host_wait_ms(self) -> float:
        """Host ms of the spans where the host blocks on the device."""
        return sum(s.host_ms for n, s in self.spans.items()
                   if n.partition(".")[2].startswith("wait"))

    def stream_latency(self):
        """(first_commit_ms, p50, p99) over the recorded chunk rounds, or
        None when no streaming ran."""
        if not self.stream_chunk_ms:
            return None
        arr = np.asarray(self.stream_chunk_ms)
        return (self.stream_first_commit_ms,
                float(np.percentile(arr, 50)),
                float(np.percentile(arr, 99)))
