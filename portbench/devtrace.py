"""The device trace of a traced run, in two windows after the untraced one:

* the device window, under torch.profiler with CUDA activity alone: the
  seconds in which an operation ran on the device, and time by kernel
  name.  Recording only the card's activity keeps the host's own pace
  near that of an untraced window.
* the host window, under CPU and CUDA activity: only to name the longest
  idle gaps between device operations by what the host was doing there
  (the profiler's cost on the host lengthens them).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def profiler(host: bool = False):
    """The device window's profiler (CUDA activity), or with `host` the host
    window's (CPU too).  A build with no CUDA activity (the CPU rehearsals)
    records the host's alone and finds no device operation."""
    A = torch.profiler.ProfilerActivity
    want = {A.CUDA, A.CPU} if host else {A.CUDA}
    acts = [a for a in torch.profiler.supported_activities() if a in want]
    return torch.profiler.profile(activities=acts or [A.CPU])


def _span(ev) -> Tuple[float, float]:
    """(start, end) in seconds of a raw profiler event."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


def _events(prof):
    """(device events, host events), each [(start, end, name)]."""
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("portbench."):
            continue    # the harness's own annotations, mirrored on the device
        s, e = _span(ev)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((s, e, ev.name()))
        else:
            host.append((s, e, ev.name()))
    dev.sort()
    return dev, host


def _busy_and_gaps(dev) -> Tuple[float, List[Tuple[float, float]]]:
    """The union of the device intervals' lengths, and the gaps between."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def summarize(prof, t0: float, t1: float) -> Dict:
    """The device window: busy_s (the union of device operations'
    intervals), window_s (t1 - t0, host perf_counter seconds around the
    traced calls) and seconds by device operation name."""
    dev, _ = _events(prof)
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    busy, _ = _busy_and_gaps(dev)
    return {"busy_s": busy, "window_s": t1 - t0, "by_name": by_name,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}


def idle_gaps(prof) -> List[list]:
    """The host window: its ten longest idle gaps, each named by the
    innermost host operation running at its middle."""
    dev, host = _events(prof)
    _, gaps = _busy_and_gaps(dev)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inside = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "host (no op)"
        named.append([name, b - a])
    return named
