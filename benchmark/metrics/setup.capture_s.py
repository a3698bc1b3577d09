"""setup.capture_s (s): the process's ``setup.warm_up`` and
``setup.capture`` totals (``core/trace.snapshot()``): each compiled graph's
eager warm-up and its capture as CUDA graphs
(``core/executor.CompiledGraph``), less the kernel libraries' load and
build that the warm-up sets off (``setup.kernels_s``)."""

from benchmark import setup_totals


def read(r):
    return setup_totals.read(("setup.warm_up", "setup.capture"))
