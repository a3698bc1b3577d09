"""Activation-range observers for PTQ calibration.

Copy of ``paddle_lite_tpu/quant/observers.py`` (numpy only).  The reference consumed scales computed offline by PaddleSlim's calibration
(abs_max / moving_average_abs_max / histogram-percentile / KL-entropy, which
its ``fake_quantize_*`` ops then carried into the graph); here calibration is
a built-in subsystem.  Observers ingest per-batch device-side statistics
(scalar abs-max, or a fixed-bin histogram for the two-pass methods) so no
full activation tensor ever leaves the chip during calibration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.types import CalibMethod


class Observer:
    """Accumulates statistics for ONE tensor across calibration batches."""

    needs_histogram = False

    def update_absmax(self, absmax: float) -> None:
        raise NotImplementedError

    def update_histogram(self, hist: np.ndarray, hist_max: float) -> None:
        pass

    def scale(self) -> float:
        raise NotImplementedError

    def _to_scale(self, amax: float) -> float:
        return max(float(amax), 1e-10) / 127.0


class AbsMaxObserver(Observer):
    def __init__(self) -> None:
        self.amax = 0.0

    def update_absmax(self, absmax: float) -> None:
        self.amax = max(self.amax, float(absmax))

    def scale(self) -> float:
        return self._to_scale(self.amax)


class MovingAverageAbsMaxObserver(Observer):
    """EMA of per-batch abs-max (fake_quantize_moving_average_abs_max)."""

    def __init__(self, momentum: float = 0.9) -> None:
        self.momentum = momentum
        self.avg: Optional[float] = None

    def update_absmax(self, absmax: float) -> None:
        a = float(absmax)
        self.avg = a if self.avg is None else self.momentum * self.avg + (1 - self.momentum) * a

    def scale(self) -> float:
        return self._to_scale(self.avg or 0.0)


class HistogramObserver(Observer):
    """Base for the two-pass methods: pass 1 records abs-max, pass 2 fills a
    fixed-bin histogram of |x| over [0, amax]."""

    needs_histogram = True

    def __init__(self, bins: int = 2048) -> None:
        self.bins = bins
        self.amax = 0.0
        self.hist = np.zeros(bins, np.float64)

    def update_absmax(self, absmax: float) -> None:
        self.amax = max(self.amax, float(absmax))

    def update_histogram(self, hist: np.ndarray, hist_max: float) -> None:
        # hist computed over [0, self.amax] on device with self.bins bins
        self.hist += np.asarray(hist, np.float64)


class PercentileObserver(HistogramObserver):
    def __init__(self, percentile: float = 0.9999, bins: int = 2048) -> None:
        super().__init__(bins)
        self.percentile = percentile

    def scale(self) -> float:
        total = self.hist.sum()
        if total == 0:
            return self._to_scale(self.amax)
        cdf = np.cumsum(self.hist) / total
        idx = int(np.searchsorted(cdf, self.percentile))
        amax = (idx + 1) / self.bins * self.amax
        return self._to_scale(amax)


class EntropyObserver(HistogramObserver):
    """KL-divergence calibration (TensorRT-style, as in PaddleSlim's
    post-training 'KL' method): choose the clip threshold whose quantized
    distribution minimizes KL(P || Q)."""

    def scale(self) -> float:
        total = self.hist.sum()
        if total == 0:
            return self._to_scale(self.amax)
        hist = self.hist / total
        nlevels = 128
        best_kl, best_t = np.inf, self.bins
        start = max(nlevels, self.bins // 8)
        for t in range(start, self.bins + 1, max(1, (self.bins - start) // 64)):
            p = hist[:t].copy()
            p[-1] += hist[t:].sum()  # clip outliers into last bin
            # quantize t bins down to nlevels
            chunk = t / nlevels
            q = np.zeros(t)
            for i in range(nlevels):
                lo, hi = int(np.floor(i * chunk)), int(np.ceil((i + 1) * chunk))
                hi = min(hi, t)
                mass = hist[lo:hi].sum()
                nz = np.count_nonzero(hist[lo:hi])
                if nz:
                    q[lo:hi] = np.where(hist[lo:hi] > 0, mass / nz, 0)
            ps, qs = p.sum(), q.sum()
            if ps <= 0 or qs <= 0:
                continue
            p /= ps
            q /= qs
            mask = p > 0
            kl = float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_t = kl, t
        amax = best_t / self.bins * self.amax
        return self._to_scale(amax)


def make_observer(method: CalibMethod, **kw) -> Observer:
    if method == CalibMethod.ABS_MAX:
        return AbsMaxObserver()
    if method == CalibMethod.MOVING_AVERAGE_ABS_MAX:
        return MovingAverageAbsMaxObserver(**kw)
    if method == CalibMethod.PERCENTILE:
        return PercentileObserver(**kw)
    if method == CalibMethod.ENTROPY:
        return EntropyObserver(**kw)
    raise ValueError(method)
