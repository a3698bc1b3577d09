"""Per-model serving configs — a copy of ``paddle_lite_tpu/models/
zoo_config.py`` (the port may not import it).

``RECOMMENDED`` holds the reference's per-model non-default ``QuantConfig``
fields, each backed there by an A/B measured on a TPU; none was measured on
the H100.  ``recommended_quant(model)`` is what ``tools/benchmark`` builds
its config from.  ``recommended_quant("ssd")`` asks for bf16 islands, which
the port's ``tools.opt.optimize`` does not take yet (it raises
``NotImplementedError``); ``--no-zoo-config`` runs SSD with fp32 islands.
"""

from __future__ import annotations

from ..quant.quantize_pass import QuantConfig

# model name (as resolve_builder spells it) -> non-default fields, as the
# reference's table has them
RECOMMENDED: dict = {
    "mobilenet_v1": {},
    "resnet": {},
    "mobilenet_v3": {},
    "ssd": {"island_dtype": "bfloat16"},
    "ppocr_det": {"quant_depthwise": False},
    "dbnet": {"quant_depthwise": False},
    "ppocr_rec": {"island_dtype": "bfloat16"},
    "crnn": {"island_dtype": "bfloat16"},
    "ppocr_rec_long": {"island_dtype": "bfloat16"},
    "crnn_long": {"island_dtype": "bfloat16"},
    "ernie_tiny": {"island_dtype": "bfloat16"},
}


def recommended_quant(model: str, **overrides) -> QuantConfig:
    """The reference's ``QuantConfig`` for a zoo model (see RECOMMENDED);
    unknown models get the plain defaults.  ``overrides`` win."""
    kw = dict(RECOMMENDED.get(model, {}))
    kw.update(overrides)
    return QuantConfig(**kw)
