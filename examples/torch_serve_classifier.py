"""End-to-end serving example on the card: camera frame → CV preprocess →
continuous batcher → int8 MobileNetV1 → top-k labels.

The PyTorch / CUDA port's twin of ``examples/serve_classifier.py``: the
same pipeline through ``paddle_lite_tpu_torch`` (its ``cv`` binding on the
host, its ``ContinuousBatcher`` over compiled predictors on the card).

Run: ``python examples/torch_serve_classifier.py`` (on the card; pass
``--device cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from paddle_lite_tpu_torch import QuantConfig, cv
from paddle_lite_tpu_torch.models import mobilenet_v1
from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig, ContinuousBatcher
from paddle_lite_tpu_torch.runtime.predictor import create_predictor

IMAGE_SIZE = 224
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def make_predictor(batch: int, image_size: int = IMAGE_SIZE, device=None):
    rng = np.random.default_rng(0)
    g = mobilenet_v1.build(batch=batch, image_size=image_size, seed=0)
    return create_predictor(
        g,
        quant=QuantConfig(),
        # synthetic calibration for the demo; feed real data in production
        calib_batches=[{
            "image": rng.normal(size=(batch, image_size, image_size, 3))
            .astype(np.float32)
        }],
        device=device,
    )


def preprocess(frame_nv12_y: np.ndarray, frame_nv12_uv: np.ndarray,
               h: int, w: int, image_size: int = IMAGE_SIZE) -> np.ndarray:
    rgb = cv.nv_to_rgb(frame_nv12_y, frame_nv12_uv, h, w)
    rgb = cv.resize(rgb, image_size, image_size)
    return cv.to_tensor(rgb, MEAN, STD)  # (H, W, 3) f32 NHWC-ready


def nv12_frame(h: int, w: int, seed: int):
    """A random NV12 frame: its Y plane and its interleaved UV plane."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w), dtype=np.uint8))


def serve(batcher, clients: int, frame=(480, 640), image_size: int = IMAGE_SIZE) -> list:
    """`clients` threads, each preprocessing one frame and sending it
    through `batcher`; returns each client's top-5 classes."""
    h, w = frame
    tops = [None] * clients

    def client(i: int):
        y, uv = nv12_frame(h, w, seed=i)
        out = batcher.infer({"image": preprocess(y, uv, h, w, image_size)}, timeout=300)
        probs = next(iter(out.values())).cpu().numpy()
        tops[i] = np.argsort(probs)[-5:][::-1].tolist()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return tops


def main(device=None, clients: int = 6, buckets=(1, 2, 4, 8), frame=(480, 640),
         image_size: int = IMAGE_SIZE) -> list:
    batcher = ContinuousBatcher(
        lambda b: make_predictor(b, image_size, device),
        BatcherConfig(buckets=buckets, max_wait_ms=3.0))
    t0 = time.time()
    try:
        tops = serve(batcher, clients, frame, image_size)
    finally:
        batcher.close()
    for i, top5 in enumerate(tops):
        print(f"client {i}: top-5 classes {top5}")
    print(f"served {clients} requests in {time.time() - t0:.2f}s "
          f"(batches: {batcher.stats['batches']})")
    return tops


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
