"""paddle_lite_tpu_torch — the PyTorch / CUDA port of paddle_lite_tpu.

The same engine as the JAX package beside it (``paddle_lite_tpu``, the
reference this package is tested against), in PyTorch on an NVIDIA H100:
plain ops are PyTorch under the ``"torch"`` kernel tag (also the CPU path),
and the TPU's Pallas kernels are rewritten by hand in CUDA C++ for
``sm_90a`` under the ``"cuda"`` tag (``ops/kernels``, sources in ``csrc``).
This package imports neither ``jax`` nor any module of the JAX package.

Layer map:
  runtime.predictor   Predictor / create_predictor (device="cuda" default)
  runtime.batcher     ContinuousBatcher over bucketed compiled predictors
  tools.opt           optimize: fusions, calibration, PTQ, kernel pick
  tools.benchmark     img/s of a zoo model; tools.batch_tune its buckets
  core                IR, builder, registry, passes, eager executor and
                      compile_graph (the graph captured as a CUDA graph)
  ops                 torch impls; ops.kernels: the CUDA kernels
  formats.interop     graphs carried across from the JAX package
"""

from . import ops  # registers all operators & kernels
from . import passes  # registers all graph passes
from .core.builder import GraphBuilder
from .core.executor import build_callable, compile_graph, stage_weights
from .core.ir import Graph
from .core.pass_manager import PassManager
from .core.types import CalibMethod, Precision, QuantInfo
from .quant.calibrate import calibrate
from .quant.quantize_pass import QuantConfig, ptq_quantize

__version__ = "0.1.0"
