"""The program's own set-up totals, for the set-up readers.

``paddle_lite_tpu_torch/core/trace.py`` times its once-a-process work
(``setup_span``: the passes, calibration, the kernel libraries' load and
build, warm-up, capture) on the host clock, as self seconds, into totals
that live in the process: :func:`read` sums some of them at the end of a
run, after the predictor is freed.  A program without those spans (an
older commit) gives None, which its readers print as nothing to read.
"""

from __future__ import annotations

from typing import Optional, Sequence


def read(names: Sequence[str]) -> Optional[float]:
    """Seconds the process spent in the program's set-up spans `names`, or
    None where it has none of them (or no ``core.trace``)."""
    try:
        from paddle_lite_tpu_torch.core import trace
    except ImportError:
        return None
    totals = trace.snapshot()["totals"]
    found = [totals[n][0] for n in names if n in totals]
    return sum(found) if found else None
