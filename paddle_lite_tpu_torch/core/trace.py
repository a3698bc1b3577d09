"""The program's spans and counters, on the profiler's clock.

- :func:`span` names a region of the request path (``"plt." + name``):
  while a profiler records, torch's fast ``RecordFunction`` (no op
  dispatch), on the timeline and the clock of the card's CUPTI events;
  otherwise one shared context that does nothing, so a span costs one flag
  check and no op dispatch when nothing traces.
- :func:`setup_span` names once-a-process work (passes, calibration, the
  kernel libraries' load, warm-up, capture): it always adds its host-clock
  seconds, less those of the set-up spans nested in it on its thread (a
  warm-up's lazy kernel load is the load's), and one to :data:`totals`
  under its name, so the totals add up; it is a span too.
- :func:`count` adds to :data:`counters`: the work that should happen once,
  so that more of it after set-up shows (``graph.captures``: a graph
  captured again; ``kernels.builds``: a library compiled again).  Nothing
  on the request path counts.

:func:`snapshot` copies both; they live as long as the process, so freeing
a predictor leaves them::

    from paddle_lite_tpu_torch.core import trace
    pred = create_predictor(graph, quant=QuantConfig(), calib_batches=batches)
    trace.snapshot()["totals"]["setup.calibrate"]    # [seconds, entries]
    trace.snapshot()["counters"]["graph.captures"]   # CUDA graphs captured

``tools/trace.trace`` writes a Chrome trace that shows the spans.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "plt."

totals: Dict[str, List[float]] = {}  # setup span name -> [self seconds, entries]
counters: Dict[str, int] = {}
_LOCK = threading.Lock()  # guards totals and counters
_local = threading.local()  # .open: this thread's set-up spans open
_NULL = contextlib.nullcontext()


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    return torch.profiler.record_function(name)


def span(name: str):
    """``plt.<name>`` on the profiler's timeline while one records, else a
    context that does nothing."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(PREFIX + name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def setup_span(name: str) -> Iterator[None]:
    """A span that also adds its host-clock seconds, less those of the
    set-up spans nested in it, to ``totals[name]``."""
    stack = _local.__dict__.setdefault("open", [])
    stack.append(0.0)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        inner = stack.pop()
        if stack:
            stack[-1] += dt
        with _LOCK:
            row = totals.setdefault(name, [0.0, 0])
            row[0] += dt - inner
            row[1] += 1


def snapshot() -> dict:
    """``{"totals": {name: [seconds, entries]}, "counters": {name: n}}``,
    copies."""
    with _LOCK:
        return {"totals": {k: list(v) for k, v in totals.items()},
                "counters": dict(counters)}


def reset() -> None:
    """Clear the totals and the counters."""
    with _LOCK:
        totals.clear()
        counters.clear()
