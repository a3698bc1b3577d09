"""Per-model serving configs, measured on the card.

Counterpart of ``paddle_lite_tpu/models/zoo_config.py`` (the port may not
import it).  ``RECOMMENDED`` holds each model's non-default ``QuantConfig``
fields; an entry ships only where an A/B on the H100 measured it at least
1 % faster than the ``QuantConfig`` defaults (compiled, input on the card,
in turns) and the model's fidelity bar still held (``chip_smoke.py`` phase
16c, which A/Bs the reference's entries every run; ``PERF.md`` §6).

The reference's table was measured on a TPU: bf16 islands for SSD, the
CRNNs and ERNIE-tiny, float depthwise convs for DBNet.  On the card every
one of them read slower than the defaults (NVIDIA H100 80GB HBM3, 700.00
W: SSD b32 bf16 islands ×0.918, CRNN b64 / 320 ×0.822, ERNIE-tiny b32 /
128 ×0.835; DBNet b4 / 640 with float depthwise convs ×0.929, its int8
depthwise convs on the kernel), so every entry is
``{}``: the card's table is the defaults.  The ``ppocr_*`` and ``*_long``
aliases follow their models.  ``recommended_quant(model)`` is what
``tools/benchmark`` builds its config from (``--no-zoo-config``: the
defaults, the same config today).
"""

from __future__ import annotations

from ..quant.quantize_pass import QuantConfig

# model name (as resolve_builder spells it) -> non-default fields
RECOMMENDED: dict = {
    "mobilenet_v1": {},
    "resnet": {},
    "mobilenet_v3": {},
    "ssd": {},
    "ppocr_det": {},
    "dbnet": {},
    "ppocr_rec": {},
    "crnn": {},
    "ppocr_rec_long": {},
    "crnn_long": {},
    "ernie_tiny": {},
}


def recommended_quant(model: str, **overrides) -> QuantConfig:
    """The card's ``QuantConfig`` for a zoo model (see RECOMMENDED);
    unknown models get the plain defaults.  ``overrides`` win."""
    kw = dict(RECOMMENDED.get(model, {}))
    kw.update(overrides)
    return QuantConfig(**kw)
