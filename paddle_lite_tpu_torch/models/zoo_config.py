"""Per-model serving configs — a copy of ``paddle_lite_tpu/models/
zoo_config.py`` (the port may not import it).

``RECOMMENDED`` holds the reference's per-model non-default ``QuantConfig``
fields, each backed there by an A/B measured on a TPU (bf16 islands for
SSD, the CRNNs and ERNIE-tiny; float depthwise convs for DBNet); none of
them was measured on the H100, so nothing here says they are the better
choice on it.  The table stays the reference's: ``chip_smoke.py`` reads SSD
and CRNN with fp32 and with bf16 islands in turns on the card and
``PERF.md`` holds what it saw.  ``recommended_quant(model)`` is what
``tools/benchmark`` builds its config from (``--no-zoo-config``: the
``QuantConfig`` defaults).
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
