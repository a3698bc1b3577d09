"""Continuous batcher — request-level parallelism for serving.

Port of ``paddle_lite_tpu/runtime/batcher.py`` (``BatcherConfig``,
``ContinuousBatcher``; the same contract): requests queue up, are grouped
into the smallest fitting *bucket* batch size, padded with zeros, run as
one call of that bucket's predictor, and each request's slice of the
outputs resolves its future.  Fixed buckets are what keeps every call on a
captured graph: each bucket's predictor (a ``Predictor`` from the factory)
is one CUDA graph of a fixed batch, built on first use and kept.

One dispatcher thread owns the predictors, so none is called from two
threads.  ``Predictor.run`` returns fresh output tensors on the card
without waiting for them, so the dispatcher collects the next batch while
the card computes this one; a client's first read of its result (e.g.
``.cpu()``) is its wait.  A batch that raises fails only its own futures.

With ``BatcherConfig.model`` naming an entry of the port's batch table
(``runtime/batch_table.py``), the table is read once, here: the ladder is
capped at the model's best measured batch and ``n`` requests go to the
bucket that serves them fastest.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from . import batch_table


@dataclasses.dataclass
class BatcherConfig:
    buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)
    max_wait_ms: float = 2.0  # linger before dispatching a partial batch
    max_queue: int = 1024
    # a model of the batch table (runtime/batch_table.py): caps the ladder
    # at its best measured batch and routes n requests to the fastest bucket
    model: Optional[str] = None
    table_dir: Optional[str] = None


@dataclasses.dataclass
class _Pending:
    inputs: Dict[str, np.ndarray]  # batch-1 arrays (leading dim 1)
    future: Future
    enqueued_at: float


class ContinuousBatcher:
    """Groups single-sample requests into bucketed batches.

    ``predictor_factory(batch)`` returns a Predictor-like object whose
    ``run(inputs)`` takes and returns name-keyed arrays with leading batch
    dim ``batch``.  It is called on the dispatcher thread, once per bucket.
    """

    def __init__(
        self,
        predictor_factory: Callable[[int], Any],
        config: Optional[BatcherConfig] = None,
    ):
        self.config = config or BatcherConfig()
        self._entry: Dict[int, float] = {}
        if self.config.model is not None:
            self._entry = batch_table.load_entry(self.config.model,
                                                 self.config.table_dir)
            best = batch_table.best_bucket(self._entry, self.config.buckets)
            if best is not None:
                capped = tuple(b for b in self.config.buckets if b <= best)
                if best not in capped:  # a peak off the ladder
                    capped = capped + (best,)
                self.config = dataclasses.replace(self.config, buckets=capped)
        self._factory = predictor_factory
        self._predictors: Dict[int, Any] = {}
        self._queue: "queue.Queue[_Pending]" = queue.Queue(self.config.max_queue)
        self._stop = threading.Event()
        self.stats = {"batches": 0, "requests": 0, "padded_slots": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="plt-torch-batcher")
        self._thread.start()

    # ---- client API ------------------------------------------------------
    def submit(self, inputs: Dict[str, np.ndarray]) -> Future:
        """Submit one request (arrays WITHOUT the batch dim).  Returns a
        Future resolving to name-keyed outputs, the batch dim stripped:
        views of tensors that no later batch writes."""
        f: Future = Future()
        batched = {k: np.asarray(v)[None, ...] for k, v in inputs.items()}
        self._queue.put(_Pending(batched, f, time.perf_counter()))
        return f

    def infer(self, inputs: Dict[str, np.ndarray], timeout: Optional[float] = None):
        return self.submit(inputs).result(timeout)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # ---- dispatcher ------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        b = batch_table.bucket_for(self._entry, n, self.config.buckets)
        if b is not None:
            return b
        for b in sorted(self.config.buckets):
            if b >= n:
                return b
        return max(self.config.buckets)

    def _predictor(self, bucket: int):
        if bucket not in self._predictors:
            self._predictors[bucket] = self._factory(bucket)
        return self._predictors[bucket]

    def _collect(self) -> List[_Pending]:
        """Block for the first request, then linger up to max_wait_ms or
        until the largest bucket fills."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        max_b = max(self.config.buckets)
        deadline = time.perf_counter() + self.config.max_wait_ms / 1e3
        while len(batch) < max_b:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._dispatch(batch)
            except Exception as e:  # a failing batch fails only its futures
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _dispatch(self, batch: List[_Pending]) -> None:
        n = len(batch)
        bucket = self._bucket_for(n)
        pred = self._predictor(bucket)
        stacked: Dict[str, np.ndarray] = {}
        for k in batch[0].inputs:
            arrs = [p.inputs[k] for p in batch]
            if bucket > n:
                arrs = arrs + [np.zeros_like(arrs[0])] * (bucket - n)
            stacked[k] = np.concatenate(arrs, axis=0)
        out = pred.run(stacked)
        for i, p in enumerate(batch):
            p.future.set_result({k: v[i] for k, v in out.items()})
        self.stats["batches"] += 1
        self.stats["requests"] += n
        self.stats["padded_slots"] += bucket - n
