"""Variable-length OCR strip serving on the card: LengthBucketer +
ContinuousBatcher.

The PyTorch / CUDA port's twin of ``examples/serve_ocr_strips.py``.
Recognition strips arrive at arbitrary widths (aspect-preserving crops of
detected text lines).  A captured CUDA graph takes one shape, so the
serving stack pads each strip UP to a width bucket and routes it to a
per-(width, batch)-bucket compiled predictor: length bucketing
(``runtime/length_bucketer.py``) over count bucketing
(``runtime/batcher.py``).  CTC decoding is pad-robust (trailing background
columns decode to blanks), which is why width padding is safe for CRNN;
see the length bucketer's docstring for models without pad-robust heads.

Run: ``python examples/torch_serve_ocr_strips.py`` (``--device cpu`` for
the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np

from paddle_lite_tpu_torch.models.ppocr import build_rec
from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig
from paddle_lite_tpu_torch.runtime.length_bucketer import LengthBucketer
from paddle_lite_tpu_torch.runtime.predictor import Predictor
from paddle_lite_tpu_torch.tools.opt import optimize

HEIGHT = 32
CHARSET = "abcdefghijklmnopqrstuvwxyz0123456789"


def make_server(width_buckets=(64, 128, 256), num_chars=len(CHARSET),
                hidden: int = 48, device=None) -> LengthBucketer:
    """Per-(width, batch)-bucket CRNN predictors behind a LengthBucketer."""

    def factory(batch: int, width: int) -> Predictor:
        g = build_rec(batch=batch, width=width, hidden=hidden,
                      num_chars=num_chars, seed=0)
        optimize(g, device=device)
        return Predictor(g, device=device)

    return LengthBucketer(
        factory,
        length_buckets=width_buckets,
        seq_axes={"image": 1},  # per-request strips are (H, W, 3)
        batcher_config=BatcherConfig(buckets=(1, 2, 4, 8), max_wait_ms=3.0),
    )


def decode(outputs: dict) -> str:
    ids = next(v for v in outputs.values() if v.ndim == 1)
    return "".join(CHARSET[int(c) % len(CHARSET)] for c in ids if c >= 0)


def main(device=None) -> list:
    server = make_server(device=device)
    rng = np.random.default_rng(0)
    widths = [50, 90, 120, 200, 60]  # ragged arrivals
    futures = [
        server.submit({"image": rng.normal(
            size=(HEIGHT, w, 3)).astype(np.float32)})
        for w in widths
    ]
    texts = []
    try:
        for w, f in zip(widths, futures):
            texts.append(decode(f.result(timeout=600)))
            print(f"strip w={w:4d} -> {texts[-1]!r}")
        print("stats:", server.stats)
    finally:
        server.close()
    return texts


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
