"""End-to-end PP-OCR pipeline demo on the card: image → DBNet text
detection → box extraction → crop/resize → CRNN recognition → CTC decode.

The PyTorch / CUDA port's twin of ``examples/ocr_pipeline.py``: both
models run int8 through the port's optimize pipeline on the card with
their zoo configs (``models/zoo_config.py``, measured on the card); the
host-side glue (DB postprocess, crops, charset decode) runs on the CPU
around the predictors, through the port's ``cv`` and ``db_postprocess``.

Run: ``python examples/torch_ocr_pipeline.py`` (``--device cpu`` for the
CPU).  Weights are random — the demo shows the pipeline plumbing, not
trained-model accuracy.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np

from paddle_lite_tpu_torch import cv
from paddle_lite_tpu_torch.models.ppocr import build_det, build_rec
from paddle_lite_tpu_torch.models.zoo_config import recommended_quant
from paddle_lite_tpu_torch.runtime.predictor import create_predictor
from paddle_lite_tpu_torch.tools.db_postprocess import TextBox, extract_boxes

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# demo charset; a real deployment loads the dict file the model trained with
CHARSET = "abcdefghijklmnopqrstuvwxyz0123456789-.,:/() "


def synthetic_document(h: int, w: int, n_lines: int = 4,
                       seed: int = 0) -> np.ndarray:
    """White page with dark text-like line blocks (uint8 HWC)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 245, np.uint8)
    for _ in range(n_lines):
        lh = int(rng.integers(h // 20, h // 10))
        y = int(rng.integers(0, h - lh))
        x1 = int(rng.integers(0, w // 3))
        x2 = int(rng.integers(2 * w // 3, w))
        block = img[y:y + lh, x1:x2]
        # words: dark runs separated by gaps
        t = np.linspace(0, (x2 - x1) / max(lh, 1), x2 - x1)
        word = (np.sin(t * 3.1) > -0.4)
        block[:, word] = rng.integers(10, 60)
    return img


def make_pipeline(det_size: int = 320, rec_width: int = 320,
                  rec_batch: int = 8, hidden: int = 48,
                  num_chars: int = len(CHARSET), device=None):
    """Build (det_predictor, rec_predictor) with synthetic calibration."""
    rng = np.random.default_rng(0)
    det_g = build_det(batch=1, image_size=det_size)
    det = create_predictor(
        det_g, quant=recommended_quant("ppocr_det"),
        calib_batches=[{
            "image": rng.normal(size=(1, det_size, det_size, 3))
            .astype(np.float32)}],
        device=device)
    rec_g = build_rec(batch=rec_batch, width=rec_width, hidden=hidden,
                      num_chars=num_chars)
    rec = create_predictor(
        rec_g, quant=recommended_quant("ppocr_rec"),
        calib_batches=[{
            "image": rng.normal(size=(rec_batch, 32, rec_width, 3))
            .astype(np.float32)}],
        device=device)
    return det, rec


def recognize(det, rec, image: np.ndarray,
              max_boxes: int = 8) -> List[Tuple[TextBox, str]]:
    """Full pipeline on one uint8 HWC image."""
    det_size = det.input_shape("image")[1]
    rec_batch, rec_h, rec_w, _ = rec.input_shape("image")

    scale_y = image.shape[0] / det_size
    scale_x = image.shape[1] / det_size
    resized = cv.resize(image, det_size, det_size)
    feed = cv.to_tensor(resized, MEAN, STD)[None]
    prob = det.run({"image": feed})[det.output_names[0]][0].cpu().numpy()
    boxes = extract_boxes(prob, max_boxes=max_boxes)

    crops = np.zeros((rec_batch, rec_h, rec_w, 3), np.float32)
    kept: List[TextBox] = []
    for b in boxes[:rec_batch]:
        x1 = int(b.x1 * scale_x)
        x2 = max(int(b.x2 * scale_x), x1 + 2)
        y1 = int(b.y1 * scale_y)
        y2 = max(int(b.y2 * scale_y), y1 + 2)
        crop = image[max(y1, 0):y2, max(x1, 0):x2]
        if crop.size == 0:
            continue
        crops[len(kept)] = cv.to_tensor(
            cv.resize(crop, rec_h, rec_w), MEAN, STD)
        kept.append(b)
    if not kept:
        return []

    out = rec.run({"image": crops})
    decoded = (out["ctc_decoded"] if "ctc_decoded" in out
               else out[rec.output_names[1]]).cpu().numpy()
    results = []
    for i, b in enumerate(kept):
        ids = [int(c) for c in decoded[i] if c >= 0]
        text = "".join(CHARSET[c % len(CHARSET)] for c in ids)
        results.append((b, text))
    return results


def main(device=None) -> list:
    det, rec = make_pipeline(device=device)
    image = synthetic_document(640, 960)
    results = recognize(det, rec, image)
    print(f"{len(results)} text regions:")
    for box, text in results:
        print(f"  ({box.x1},{box.y1})-({box.x2},{box.y2}) "
              f"score={box.score:.2f} text={text!r}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
