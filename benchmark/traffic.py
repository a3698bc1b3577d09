"""The one traffic generator: reads a mix (``traffic/<name>.json``) and
drives the program with it.

Two kinds of mix:

- ``"closed"``: ``Predictor.run`` back to back at ``batch``, cycling through
  a pool of ``pool_batches`` distinct batches, on the card (``"input":
  "card"``) or as numpy arrays in pageable host memory (``"host"``).  At most
  ``in_flight`` calls are on the card at once: before each call the host
  waits for the call ``in_flight`` back, as a pipeline with a bounded queue
  does.  The outputs of ``checked_calls`` calls, drawn from the seed by
  reservoir sampling, and of the last call are kept for the check.
- ``"poisson"``: single-image requests, each a numpy array drawn from a pool
  of ``pool_images`` by the seed, sent open-loop at ``rate_per_s`` with
  exponential gaps (one fixed set, in an order drawn from the seed) through the program's
  ``ContinuousBatcher``.  A request is timed from when it was due to when
  its row of the outputs is on the host; a reader thread takes the answers
  in order and copies each batch's outputs to the host once the batch's
  completion event has fired (on a stream of its own, so no later batch
  delays the read).

Both stop issuing when ``seconds`` have passed; what was issued is finished
and counted.
"""

from __future__ import annotations

import collections
import json
import queue
import random
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

KINDS = ("closed", "poisson")
ANSWER_WAIT_S = 60.0  # how long past the window an answer is waited for


def load(root: Path, name: str) -> dict:
    mix = json.loads((root / "benchmark" / "traffic" / f"{name}.json").read_text())
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic {name}: kind must be one of {KINDS}")
    return mix


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_closed(pred, feeds: List[dict], answer: Callable, mix: dict, seconds: float,
               seed: int, device: torch.device, tracer=None) -> dict:
    """The closed loop over `feeds`, one a pool batch; returns the calls
    made, the window's wall time, the host time inside ``Predictor.run``
    and the kept answers (``answer(outputs)``) as (pool index, answer)."""
    rng = random.Random(seed)
    keep = int(mix["checked_calls"])
    in_flight = int(mix["in_flight"])
    kept: List[tuple] = []
    pending: collections.deque = collections.deque()
    issue_s, n, last = 0.0, 0, None
    _sync(device)
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        if tracer is not None:
            tracer.tick(elapsed)
        if len(pending) >= in_flight:
            pending.popleft().synchronize()
        a = time.perf_counter()
        out = pred.run(feeds[n % len(feeds)])
        issue_s += time.perf_counter() - a
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
        item = (n % len(feeds), answer(out))
        if len(kept) < keep:
            kept.append(item)
        else:
            j = rng.randrange(n + 1)
            if j < keep:
                kept[j] = item
        last = item
        if tracer is not None and tracer.active:
            tracer.calls += 1
        n += 1
    if tracer is not None:
        tracer.stop()
    _sync(device)
    wall = time.perf_counter() - t0
    if last is not None:
        kept.append(last)
    return {"calls": n, "wall_s": wall, "issue_s": issue_s, "kept": kept}


def poisson_schedule(mix: dict, seconds: float, seed: int):
    """(due offsets in seconds, pool index of each request) of the requests
    due inside the window.  Every seed gets the same gaps in another order:
    the ``n = rate * seconds`` quantiles of the exponential distribution at
    ``rate_per_s``, shuffled by the seed, so runs differ in where the bursts
    fall, not in how much work they carry."""
    rng = np.random.default_rng(seed)
    rate = float(mix["rate_per_s"])
    n = int(round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.cumsum(rng.permutation(gaps))
    choice = rng.integers(0, int(mix["pool_images"]), size=n)
    keep = int(np.searchsorted(due, seconds))
    return due[:keep], choice[:keep]


class Timed:
    """A bucket's predictor as the batcher's factory hands it out: ``run``
    is the predictor's, then a completion event is recorded on the stream
    for each output tensor, which the reader waits on."""

    def __init__(self, pred, done: Dict[int, tuple]):
        self.pred, self.done = pred, done

    def run(self, inputs):
        out = self.pred.run(inputs)
        ev = torch.cuda.Event() if self.pred.device.type == "cuda" else None
        if ev is not None:
            ev.record()
        for v in out.values():
            self.done[id(v)] = (ev, v)
        return out


def run_poisson(batcher, feeds: List[dict], answer: Callable, mix: dict, seconds: float,
                seed: int, done: Dict[int, tuple], tracer=None) -> dict:
    """The open loop through `batcher` (whose predictors are :class:`Timed`
    over `done`), each request one of `feeds`, its answer
    ``answer(outputs)``.  Returns each due request's latency (s; an unanswered one
    counts the time it was waited for), the backlog at the window's close,
    the requests answered by then, the generator's lateness, and each
    answered request's (pool index, host row)."""
    due, choice = poisson_schedule(mix, seconds, seed)
    n = len(due)
    done_at = np.full(n, np.nan)
    rows: List[Optional[np.ndarray]] = [None] * n
    sent: "queue.Queue" = queue.Queue()
    side = torch.cuda.Stream() if torch.cuda.is_available() else None
    failures: List[str] = []

    def reader():
        base_id, host = None, None
        for i in range(n):
            item = sent.get()
            if item is None:
                return
            fut, deadline = item
            try:
                row = answer(fut.result(timeout=max(deadline - time.perf_counter(), 0.0)))
            except Exception as e:  # a failed or late request counts as missing
                failures.append(f"request {i}: {e!r}")
                continue
            b = row._base if row._base is not None else row
            if id(b) != base_id:
                ev, v = done.pop(id(b))
                if side is not None:
                    with torch.cuda.stream(side):
                        side.wait_event(ev)
                        host = v.to("cpu").numpy()
                else:
                    host = v.numpy()
                base_id = id(b)
            done_at[i] = time.perf_counter()
            k = int(row.storage_offset() - b.storage_offset()) // max(row.numel(), 1)
            rows[i] = host[k]

    th = threading.Thread(target=reader, name="bench-reader", daemon=True)
    late = np.zeros(n)
    t0 = time.perf_counter()
    deadline = t0 + seconds + ANSWER_WAIT_S
    th.start()
    try:
        for i in range(n):
            t_due = t0 + due[i]
            now = time.perf_counter()
            if tracer is not None:
                tracer.tick(now - t0)
            if t_due > now:
                time.sleep(t_due - now)
            late[i] = time.perf_counter() - t_due
            sent.put((batcher.submit(feeds[choice[i]]), deadline))
        while time.perf_counter() - t0 < seconds:
            if tracer is not None:
                tracer.tick(time.perf_counter() - t0)
            time.sleep(0.001)
        if tracer is not None:
            tracer.stop()
        t_close = time.perf_counter()
    finally:
        sent.put(None)
        th.join(timeout=ANSWER_WAIT_S + 5.0)
    if th.is_alive():
        raise RuntimeError("the reader thread did not finish")
    due_abs = t0 + due
    answered = ~np.isnan(done_at)
    latency = np.where(answered, done_at - due_abs, deadline - due_abs)
    backlog = int(np.sum(~answered | (done_at > t_close)))
    return {"n": n, "latency_s": latency, "answered": answered, "backlog": backlog,
            "completed": n - backlog,
            "late_p99_s": float(np.percentile(late, 99)) if n else 0.0,
            "failures": failures, "choice": choice, "rows": rows,
            "wall_s": t_close - t0}
