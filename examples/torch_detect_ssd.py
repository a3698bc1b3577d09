"""SSD-MobileNetV1 detection demo on the card: image → int8 SSD → scored
boxes.

The PyTorch / CUDA port's twin of ``examples/detect_ssd.py``: preprocess
with the port's CV lib on the host, run the int8 predictor on the card
(its NMS on the hand-written kernel), read the fixed-shape NMS output rows
``[label, score, x1, y1, x2, y2]`` (label −1 = empty slot).  The int8
config is the port's zoo entry (``models/zoo_config.py``, measured on the
card).

Run: ``python examples/torch_detect_ssd.py`` (``--device cpu`` for the
CPU).  Weights are random — the demo shows the deployment plumbing, not
trained-model accuracy.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np

from paddle_lite_tpu_torch import cv
from paddle_lite_tpu_torch.models import ssd
from paddle_lite_tpu_torch.models.zoo_config import recommended_quant
from paddle_lite_tpu_torch.runtime.predictor import create_predictor

MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
VOC_LABELS = (
    "background aeroplane bicycle bird boat bottle bus car cat chair cow "
    "diningtable dog horse motorbike person pottedplant sheep sofa train "
    "tvmonitor").split()


def make_predictor(image_size: int = 300, device=None):
    rng = np.random.default_rng(0)
    g = ssd.build(batch=1, image_size=image_size)
    return create_predictor(
        g, quant=recommended_quant("ssd"),
        calib_batches=[{
            "image": rng.normal(size=(1, image_size, image_size, 3))
            .astype(np.float32)}],
        device=device)


def detect(pred, image: np.ndarray, score_thresh: float = 0.5,
           ) -> List[Tuple[str, float, Tuple[int, int, int, int]]]:
    """uint8 HWC image → [(label, score, (x1, y1, x2, y2))] in image pixels."""
    size = pred.input_shape("image")[1]
    h, w = image.shape[:2]
    feed = cv.to_tensor(cv.resize(image, size, size), MEAN, STD)[None]
    rows = pred.run({"image": feed})[pred.output_names[0]][0].cpu().numpy()
    results = []
    for label, score, x1, y1, x2, y2 in rows:
        if label < 0 or score < score_thresh:
            continue
        name = (VOC_LABELS[int(label)]
                if int(label) < len(VOC_LABELS) else str(int(label)))
        results.append((name, float(score),
                        (int(x1 * w), int(y1 * h), int(x2 * w), int(y2 * h))))
    return results


def main(device=None, image_size: int = 300) -> list:
    pred = make_predictor(image_size, device)
    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
    dets = detect(pred, image, score_thresh=0.1)
    print(f"{len(dets)} detections:")
    for name, score, (x1, y1, x2, y2) in dets[:10]:
        print(f"  {name:<12} {score:.3f} ({x1},{y1})-({x2},{y2})")
    return dets


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
