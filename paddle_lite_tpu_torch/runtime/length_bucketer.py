"""Length-bucketed serving for variable-length sequence models.

Port of ``paddle_lite_tpu/runtime/length_bucketer.py`` over the port's
:class:`~.batcher.ContinuousBatcher`.  Every distinct sequence length is
its own compiled program (on the card, one CUDA graph a bucket batch):
requests of any length are padded up to a small ladder of length buckets
and routed to that length's batcher (which then buckets by count), so the
compiled programs stay bounded at |length_buckets| x |batch_buckets|.

Padding semantics are the model's contract, not this router's: a CRNN
recognizer pads a strip with background columns (CTC decoding is
pad-robust); a model without an attention-mask input is not exactly
pad-invariant.  The default ``pad_fn`` zero-pads every input named in
``seq_axes`` along its axis.

Outputs are returned at the bucket length (a sequence-shaped output keeps
its padded tail; callers that need exact lengths slice with the length
they submitted).
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from .batcher import BatcherConfig, ContinuousBatcher


def default_pad_fn(inputs: Dict[str, np.ndarray], target_len: int,
                   seq_axes: Dict[str, int]) -> Dict[str, np.ndarray]:
    """Zero-pad each listed input along its sequence axis to target_len."""
    out = dict(inputs)
    for name, axis in seq_axes.items():
        a = np.asarray(out[name])
        cur = a.shape[axis]
        if cur > target_len:
            raise ValueError(
                f"input {name!r} length {cur} exceeds the largest length "
                f"bucket {target_len}")
        if cur < target_len:
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, target_len - cur)
            a = np.pad(a, widths)
        out[name] = a
    return out


class LengthBucketer:
    """Route variable-length requests to per-length-bucket batchers.

    ``predictor_factory(batch, length)`` must return a Predictor-like
    object compiled for that (batch, length); ``seq_axes`` maps each
    sequence-shaped input name to its sequence axis (WITHOUT the batch
    dim, matching :meth:`ContinuousBatcher.submit`'s convention).
    """

    def __init__(
        self,
        predictor_factory: Callable[[int, int], object],
        *,
        length_buckets: Sequence[int],
        seq_axes: Dict[str, int],
        pad_fn: Optional[Callable] = None,
        batcher_config: Optional[BatcherConfig] = None,
    ):
        if not length_buckets:
            raise ValueError("length_buckets must be non-empty")
        self.length_buckets = tuple(sorted(set(int(b) for b in length_buckets)))
        self.seq_axes = dict(seq_axes)
        self._pad_fn = pad_fn or (
            lambda ins, tl: default_pad_fn(ins, tl, self.seq_axes))
        self._factory = predictor_factory
        self._config = batcher_config or BatcherConfig()
        self._batchers: Dict[int, ContinuousBatcher] = {}
        self.stats = {"requests": 0, "padded_tokens": 0}

    def _bucket_for(self, n: int) -> int:
        for b in self.length_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"sequence length {n} exceeds the largest length bucket "
            f"{self.length_buckets[-1]}")

    def _batcher(self, length: int) -> ContinuousBatcher:
        if length not in self._batchers:
            self._batchers[length] = ContinuousBatcher(
                lambda batch, _l=length: self._factory(batch, _l),
                self._config)
        return self._batchers[length]

    def submit(self, inputs: Dict[str, np.ndarray]) -> Future:
        name, axis = next(iter(self.seq_axes.items()))
        n = int(np.asarray(inputs[name]).shape[axis])
        bucket = self._bucket_for(n)
        padded = self._pad_fn(inputs, bucket)
        self.stats["requests"] += 1
        self.stats["padded_tokens"] += bucket - n
        return self._batcher(bucket).submit(padded)

    def infer(self, inputs: Dict[str, np.ndarray],
              timeout: Optional[float] = None):
        return self.submit(inputs).result(timeout)

    def close(self) -> None:
        for b in self._batchers.values():
            b.close()
