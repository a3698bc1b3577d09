"""paddle_lite_tpu_torch — the PyTorch / CUDA port of paddle_lite_tpu.

The same engine as the JAX package beside it (``paddle_lite_tpu``, the
reference this package is tested against), in PyTorch on an NVIDIA H100:
plain ops are PyTorch under the ``"torch"`` kernel tag (also the CPU path),
and the TPU's Pallas kernels are rewritten by hand in CUDA C++ for
``sm_90a`` under the ``"cuda"`` tag (``ops/kernels``, sources in ``csrc``).
This package imports neither ``jax`` nor any module of the JAX package.

Layer map:
  runtime.predictor   Predictor / create_predictor (device="cuda" default),
                      Predictor.save / load_predictor (the light path)
  runtime.batcher     ContinuousBatcher over bucketed compiled predictors
  tools.opt           optimize: fusions, calibration, PTQ, kernel pick
  tools.benchmark     img/s of a zoo model; tools.batch_tune its buckets
  tools.accuracy_report  calibration methods compared on torch twins
                      (testing.twins, formats.importer, tools.profile)
  core                IR, builder, registry, passes, eager executor and
                      compile_graph (the graph captured as a CUDA graph);
                      core.trace: the program's spans and counters
  ops                 torch impls; ops.kernels: the CUDA kernels, and the
                      kernel table measured on the card (tune_cache,
                      autotune; tools.cli tune)
  cv                  host-side image preprocessing (native/cv.cc)
  tools.cli           the opt tool: compile / info / ops / passes / profile /
                      tune
  tools.accuracy_families, tools.eval
                      task-level accuracy of SSD / DBNet / CRNN / ERNIE
  tools.profile, tools.roofline_report, tools.gemm_roofline, tools.trace,
  tools.dump          latency by prefix, rooflines, traces, graph dumps
  formats             fluid model directories (fluid_convert), the nbf
                      artifact shared with the JAX package (artifact,
                      native/nbf.cc), graphs carried across (interop),
                      torch.export programs (aot), checkpoints (torch_ckpt)
  utils.device_info   the card's identity, published peaks and memory
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
