"""Full-scale accuracy report — the BASELINE contract measurement
(MobileNetV1-INT8 top-1 within 0.5 pts of fp32) on full architectures with
imported, trained-looking weights (``testing/twins.py``).

Port of ``paddle_lite_tpu/tools/accuracy_report.py`` (``:49-183`` there).
Without an ImageNet set or a pretrained checkpoint, ground truth is the
torch twin's fp32 prediction: `top-1 agreement` of the port's fp32 import
against the twin proves importer parity, and int8-vs-fp32 agreement is a
*stricter* stand-in for the top-1-delta contract (every disagreement counts
against it, whereas on a real test set half the flips land on the correct
label by symmetry).

Reports, per model and calibration method (abs_max / percentile / KL /
moving_average_abs_max):

- importer parity: max |twin − port| relative error on a probe batch, the
  twin run on the same device (TF32 off);
- fp32→int8 prediction agreement over N structured images;
- mean |p_int8 − p_fp32| top-probability drift;
- the worst per-layer cosines from ``tools/profile.precision_report``.

``around_first_request``, where given, is called with each method's name
and returns a context manager that wraps that method's first int8 request
(its warm-up and its CUDA-graph capture), so a caller can watch what the
request does; the report itself does not read it.

Each run goes through a compiled predictor (``runtime/predictor``) on the
device; the twin is built once per report and imported into fresh graphs
(the reference builds it again for every graph).

    python -m paddle_lite_tpu_torch.tools.accuracy_report --device cuda \\
        --model mobilenet_v1 --n-images 512 --batch 64

prints one JSON document (also written to ``--out``).  ``--device`` takes
the place of the reference's ``--platform``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Callable, ContextManager, Dict, List, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, fp32_exact, resolve_device
from ..core.ir import Graph
from ..core.types import CalibMethod
from ..formats.importer import import_state_dict
from ..models import mobilenet_v1, mobilenet_v3, resnet
from ..quant.quantize_pass import QuantConfig
from ..runtime.predictor import Predictor
from ..testing import twins
from .opt import optimize
from .profile import precision_report

MODELS = {"mobilenet_v1": (mobilenet_v1, twins.torch_mobilenet_v1),
          "mobilenet_v3": (mobilenet_v3, twins.torch_mobilenet_v3),
          "resnet": (resnet, twins.torch_resnet50)}


def build_imported(model: str, batch: int, image_size: int, seed: int = 0,
                   *, twin=None):
    """The zoo graph of `model` with the twin's weights imported: (graph,
    twin, parameters consumed).  The twin is built from `seed` unless given."""
    if model not in MODELS:
        raise ValueError(f"no twin for {model}")
    zoo, make_twin = MODELS[model]
    if twin is None:
        twin = make_twin(seed=seed)
    g = zoo.build(batch=batch, image_size=image_size, with_softmax=True)
    consumed = import_state_dict(g, twin.state_dict())
    return g, twin, consumed


def _nhwc(x: np.ndarray) -> Dict[str, np.ndarray]:
    return {"image": np.transpose(x, (0, 2, 3, 1)).copy()}


def accuracy_report(model: str, *, n_images: int = 1000, batch: int = 50,
                    image_size: int = 224, seed: int = 0,
                    methods=("abs_max", "percentile", "entropy"),
                    calib_batches: int = 4, device: DeviceLike = None,
                    around_first_request: Optional[
                        Callable[[str], ContextManager]] = None) -> dict:
    dev = resolve_device(device)
    g_fp32, twin, consumed = build_imported(model, batch, image_size, seed)

    def fresh():
        return build_imported(model, batch, image_size, twin=twin)[0]

    def run(pred: Predictor, feed) -> np.ndarray:
        return pred.run(feed)[pred.output_names[0]].cpu().numpy()

    # --- importer parity on a probe batch --------------------------------
    probe_nchw = next(twins.structured_images(batch, image_size, seed=seed + 99,
                                              batch=batch))
    twin.to(dev)
    with torch.no_grad(), fp32_exact():
        t_logits = twin(torch.from_numpy(probe_nchw).to(dev)).cpu().numpy()
    twin.to("cpu")
    t_prob = np.exp(t_logits - t_logits.max(-1, keepdims=True))
    t_prob /= t_prob.sum(-1, keepdims=True)
    pred_fp32 = Predictor(g_fp32, device=dev)
    ours = run(pred_fp32, _nhwc(probe_nchw))
    parity_rel = float(np.abs(ours - t_prob).max() / (np.abs(t_prob).max()))
    parity_agree = float((ours.argmax(-1) == t_prob.argmax(-1)).mean())

    # --- calibration data (shared across methods) -------------------------
    calib = [_nhwc(x) for x in twins.structured_images(
        calib_batches * batch, image_size, seed=seed + 1, batch=batch)]
    eval_stream = [_nhwc(x) for x in twins.structured_images(
        n_images, image_size, seed=seed + 2, batch=batch)]

    report = {
        "model": model, "n_images": n_images, "image_size": image_size,
        "params_imported": consumed,
        "importer_parity_rel_err": parity_rel,
        "importer_top1_agreement_vs_torch": parity_agree,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "methods": {},
    }

    fp32_preds: List[np.ndarray] = []
    fp32_top_prob: List[np.ndarray] = []
    for feed in eval_stream:
        out = run(pred_fp32, feed)
        fp32_preds.append(out.argmax(-1))
        fp32_top_prob.append(out.max(-1))
    del pred_fp32

    g_ref: Optional[Graph] = None  # fused fp32: the int8 graphs' topology
    for method in methods:
        g8 = fresh()
        # "kl" is the PaddleSlim/TensorRT name for the entropy method
        cfg = QuantConfig(method=CalibMethod("entropy" if method == "kl" else method))
        optimize(g8, quant=cfg, calib_batches=calib, device=dev)
        pred8 = Predictor(g8, device=dev)

        agree = total = 0
        drift = 0.0
        for i, (feed, p32, tp32) in enumerate(zip(eval_stream, fp32_preds,
                                                  fp32_top_prob)):
            with (around_first_request(method) if around_first_request and i == 0
                  else contextlib.nullcontext()):
                out = run(pred8, feed)
            p8 = out.argmax(-1)
            agree += int((p8 == p32).sum())
            total += p8.shape[0]
            drift += float(np.abs(out.max(-1) - tp32).sum())
        del pred8

        # per-layer quantization error (worst cosines)
        if g_ref is None:
            g_ref = optimize(fresh(), device=dev)
        rows = precision_report(g_ref, g8, calib[0], top=5, device=dev)
        worst = [{"var": r.var, "op": r.op_type, "cos": round(r.cos, 6)}
                 for r in rows]

        report["methods"][method] = {
            "int8_top1_agreement": agree / total,
            "top1_delta_upper_bound": 1.0 - agree / total,
            "mean_top_prob_drift": drift / total,
            "worst_layer_cosines": worst,
        }
    return report


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--model", default="mobilenet_v1", choices=sorted(MODELS))
    p.add_argument("--n-images", type=int, default=1000)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--methods", default="abs_max,percentile,entropy")
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    rep = accuracy_report(args.model, n_images=args.n_images,
                          batch=args.batch, image_size=args.image_size,
                          methods=tuple(args.methods.split(",")),
                          calib_batches=args.calib_batches, device=args.device)
    text = json.dumps(rep, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
