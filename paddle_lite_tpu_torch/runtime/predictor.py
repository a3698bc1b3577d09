"""Predictor — the user-facing inference API.

Port of ``paddle_lite_tpu/runtime/predictor.py`` (``PredictorConfig``,
``Predictor`` with ``run`` / ``__call__`` / ``clone`` and its input
validation, ``create_predictor``), the analog of the reference's
``CxxPaddleApiImpl`` / ``CreatePaddlePredictor<CxxConfig>``.  ``save`` and
``load_predictor`` wait for the formats port.

The predictor runs on the card unless asked for the CPU
(``device="cpu"``); with no card, the default raises.  It stages the graph's
weights to the device once, at construction, through
:func:`~..core.executor.compile_graph`, as the reference's predictor goes
through ``jax.jit``: on the card the first ``run`` warms the graph up (each
op folds its scales and repacks its GEMM weight) and captures it as a CUDA
graph, and every ``run`` replays it.  ``run`` takes name-keyed numpy arrays
or tensors and returns fresh name-keyed tensors on the predictor's device.
The eager loop stays reachable as ``core.executor.build_callable``.

Arithmetic: convs and matmuls on the fp32 paths (the stem conv, the fp32
predictor, softmax's input) run with TF32 off — full fp32, as in the
reference; cuDNN would otherwise use TF32 for fp32 convs on Hopper.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.executor import compile_graph
from ..core.ir import Graph


@dataclasses.dataclass
class PredictorConfig:
    """CxxConfig/MobileConfig analog."""

    validate_inputs: bool = True
    device: DeviceLike = None  # None => "cuda"


class Predictor:
    def __init__(self, graph: Graph, config: Optional[PredictorConfig] = None,
                 *, device: DeviceLike = None):
        self.graph = graph
        self.config = config or PredictorConfig()
        self.device = resolve_device(
            device if device is not None else self.config.device)
        self._fn, self._weights = compile_graph(graph, device=self.device)

    # ---- introspection (GetInputNames/GetOutputNames analog) -------------
    @property
    def input_names(self):
        return list(self.graph.inputs)

    @property
    def output_names(self):
        return list(self.graph.outputs)

    def input_shape(self, name: str):
        return self.graph.vars[name].shape

    # ---- execution -------------------------------------------------------
    def _validate(self, inputs: Dict[str, Any]) -> None:
        for name in self.graph.inputs:
            if name not in inputs:
                raise ValueError(
                    f"missing input {name!r}; expected inputs: {self.input_names}"
                )
            got = tuple(np.shape(inputs[name]))
            want = self.graph.vars[name].shape
            if got != want:
                raise ValueError(
                    f"input {name!r} has shape {got}, expected {want}"
                )
        extra = set(inputs) - set(self.graph.inputs)
        if extra:
            raise ValueError(f"unexpected inputs: {sorted(extra)}")

    def run(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if self.config.validate_inputs:
            self._validate(inputs)
        return self._fn(self._weights, inputs)

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.run(inputs)

    def clone(self, config: Optional[PredictorConfig] = None) -> "Predictor":
        """Weight-sharing clone, one a serving thread: shares the staged
        device weights and the per-op constants, and has its own static
        buffers and CUDA graph (captured on its first run), so clones on
        two threads never share an output buffer.  Only the config (e.g.
        validation) may differ."""
        c = Predictor.__new__(Predictor)
        c.graph = self.graph
        c.config = config or self.config
        c.device = self.device
        c._fn = self._fn.clone()
        c._weights = self._weights
        return c


def create_predictor(
    graph: Graph,
    *,
    quant=None,
    calib_batches: Optional[Iterable[Dict[str, np.ndarray]]] = None,
    config: Optional[PredictorConfig] = None,
    optimize: bool = True,
    device: DeviceLike = None,
) -> Predictor:
    """Full-path constructor: optimize (+quantize, calibrating on the same
    device) then wrap in a Predictor."""
    config = config or PredictorConfig()
    dev = resolve_device(device if device is not None else config.device)
    if optimize:
        from ..tools.opt import optimize as _optimize

        _optimize(graph, quant=quant, calib_batches=calib_batches, device=dev)
    return Predictor(graph, config, device=dev)
