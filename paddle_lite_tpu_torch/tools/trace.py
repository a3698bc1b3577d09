"""Profiler tracing helper — port of ``paddle_lite_tpu/tools/trace.py``.

The reference wraps ``jax.profiler`` (an xprof trace of the TPU).  Here
:func:`trace` runs ``torch.profiler`` over the block (the host's ops, and on
the card its kernels through CUPTI) and writes a Chrome trace, which
``chrome://tracing`` or Perfetto opens.  The program's own spans
(``core/trace.py``) show in it, and :func:`annotate` names a region of the
caller's (``torch.profiler.record_function``)::

    from paddle_lite_tpu_torch.tools.trace import annotate, trace
    with trace("traces") as t:
        with annotate("request"):
            pred.run(feed)
    print(t.path)  # traces/trace_<pid>_<n>.json
    # request
    #   plt.predictor.run
    #     plt.predictor.validate
    #     plt.predictor.stage_inputs
    #     plt.graph.replay       (cudaGraphLaunch; the kernels on the card)
    #     plt.predictor.clone_outputs
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator, Optional

import torch

from ..core.trace import annotate  # noqa: F401  (re-exported)

_count = itertools.count()


class Trace:
    """What :func:`trace` yields: the profiler while the block runs, and
    after it the trace file's ``path``."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.path: Optional[str] = None


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Trace]:
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t = Trace(prof)
        yield t
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    t.path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_count)}.json")
    prof.export_chrome_trace(t.path)

