"""Hand-written CUDA kernels (sources in ``paddle_lite_tpu_torch/csrc``)."""

from . import ops_cuda  # noqa: F401  (registers the "cuda" impls)
