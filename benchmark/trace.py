"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a steady
stretch of the window, reduced to what the per-layer metrics read.

:class:`Tracer` starts the profiler ``start_s`` into the window and stops it
``length_s`` after it started; the traffic loops call :meth:`Tracer.tick` as they
go.  Set-up profiles one call first (:meth:`Tracer.warm`), so the start in
the window is quick.  The
stretch in between is marked by a ``bench.window`` span, whose host times
bound the device activity counted: every kernel, copy and set on the card
(CUPTI, through the profiler), clipped to the span.  :meth:`Tracer.summary`
gives

- ``window_s`` and ``busy_s``: the span's length and the union of device
  activity inside it;
- ``kernels``: name -> [launches, seconds] of the kernels (copies and sets
  apart, under ``copies``);
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: the device's idle time inside the span by what the host was
  doing when each gap began (the innermost host op or span then running),
  the ten largest.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import torch

WINDOW_SPAN = "bench.window"
TOP = 10
LOOK_BACK = 256  # host ops looked through for the one a gap began in


class Tracer:
    def __init__(self, start_s: float, length_s: float, sync: bool):
        self.start_s, self.length_s, self.sync = start_s, length_s, sync
        self.active = False
        self.done = False
        self._prof = None
        self._span = None
        self._stop_at = 0.0
        self.calls = 0  # calls the traffic loop issued inside the span

    @staticmethod
    def warm(fn) -> None:
        """Profile `fn` once and drop the result: the profiler's first start
        (CUPTI's set-up) costs seconds, which belong to set-up, not to the
        window."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            fn()
            torch.cuda.synchronize()

    def tick(self, elapsed_s: float) -> None:
        """Start the traced stretch `start_s` into the window; stop it
        `length_s` after it started."""
        if self.done:
            return
        if not self.active and elapsed_s >= self.start_s:
            self._start()
        elif self.active and time.perf_counter() >= self._stop_at:
            self.stop()

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        if self.sync:
            torch.cuda.synchronize()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.active = True
        self._stop_at = time.perf_counter() + self.length_s

    def stop(self) -> None:
        if not self.active:
            return
        if self.sync:
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        torch.cuda.synchronize()
        self._prof.stop()
        self.active, self.done = False, True

    def summary(self) -> Optional[dict]:
        if self._prof is None or not self.done:
            return None
        t0 = time.perf_counter()
        out = summarize(self._prof.events())
        out["calls"] = self.calls
        out["reduce_s"] = time.perf_counter() - t0
        return out


def _union(intervals: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def summarize(events) -> dict:
    """The window's device activity and idle gaps from profiler events
    (times in microseconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name == WINDOW_SPAN and e.device_type != cuda]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    kernels: Dict[str, list] = {}
    copies: Dict[str, list] = {}
    intervals, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or e.name == WINDOW_SPAN:
                continue  # a host span's mirror on the device's timeline
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            is_copy = e.name.startswith(("Memcpy", "Memset"))
            row = (copies if is_copy else kernels).setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += (t - s) / 1e6
            intervals.append((s, t))
        elif e.name != WINDOW_SPAN and t > w0 and s < w1:
            host.append((s, t, e.name))
    busy = _union(intervals)
    gaps, prev = [], w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    host.sort()
    starts = [h[0] for h in host]
    by_label: Dict[str, float] = {}
    for g0, g1 in gaps:
        label = "host: no op"
        # the innermost host op at g0: the latest start at or before g0
        # whose end is not before it (looking back a bounded way)
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - LOOK_BACK, -1), -1):
            if host[j][1] >= g0:
                label = host[j][2]
                break
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e6
    ops = sorted(((n, r[1]) for n, r in list(kernels.items()) + list(copies.items())),
                 key=lambda x: -x[1])
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(t - s for s, t in busy) / 1e6,
            "kernels": kernels, "copies": copies,
            "device_ops": [[n[:160], s] for n, s in ops[:TOP]],
            "idle_gaps": [[n[:160], s] for n, s in
                          sorted(by_label.items(), key=lambda x: -x[1])[:TOP]]}
