"""Pass framework — analog of ``lite/core/mir/{pass.h,pass_manager.cc}``.

Copy of ``paddle_lite_tpu/core/pass_manager.py`` (numpy only).  Passes are
callables ``pass_fn(graph) -> None`` that mutate the Graph in place; the
:class:`PassManager` runs a named, ordered pipeline: BN folding,
activation/bias fusion into conv, QAT fake-op fusion, PTQ quantization,
precision-boundary (calib) insertion and kernel picking.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from .ir import Graph

PassFn = Callable[[Graph], None]

_PASS_REGISTRY: Dict[str, PassFn] = {}


def register_pass(name: str):
    """``REGISTER_MIR_PASS`` analog."""

    def deco(fn: PassFn) -> PassFn:
        _PASS_REGISTRY[name] = fn
        return fn

    return deco


def get_pass(name: str) -> PassFn:
    if name not in _PASS_REGISTRY:
        raise KeyError(f"pass {name!r} not registered; known: {sorted(_PASS_REGISTRY)}")
    return _PASS_REGISTRY[name]


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


class PassManager:
    def __init__(self, pipeline: Sequence[str]):
        self.pipeline = list(pipeline)

    def run(self, graph: Graph, *, verbose: bool = False) -> Graph:
        for name in self.pipeline:
            get_pass(name)(graph)
            if verbose:
                print(f"== after pass {name} ==\n{graph.dump()}")
            graph.rebuild_links()
        graph.remove_unused_vars()
        return graph


# The default optimization pipeline, in the same spirit and order as the
# reference's Optimizer::Run pass vector (lite/core/optimizer.h):
# fusions first, then quantization, then precision-cast insertion, then
# kernel picking.  Quant passes are appended by the `opt` flow when a
# QuantConfig is present (see tools/opt.py).
FP32_PIPELINE = [
    "identity_elimination",
    "conv_bn_fuse",
    "conv_elementwise_fuse",
    "conv_activation_fuse",
    "fc_fuse",
    "kernel_pick",
]

INT8_PIPELINE = [
    "identity_elimination",
    "quant_dequant_fuse",  # consume imported QAT fake-quant graphs
    "conv_bn_fuse",
    "conv_elementwise_fuse",
    "conv_activation_fuse",
    "fc_fuse",
    # ptq_quantize is inserted here dynamically by the opt tool (it needs
    # calibration data, so it is not a pure graph->graph pass)
    "precision_cast",
    "kernel_pick",
]


def run_default_pipeline(graph: Graph, *, int8: bool = False) -> Graph:
    return PassManager(INT8_PIPELINE if int8 else FP32_PIPELINE).run(graph)
