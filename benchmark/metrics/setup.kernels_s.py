"""setup.kernels_s (s): the process's ``setup.kernels_load`` and
``setup.kernels_build`` totals (``core/trace.snapshot()``): the kernel
libraries loaded and set up for the card, and built where the checkout had
none (``ops/kernels/_build.py``)."""

from benchmark import setup_totals


def read(r):
    return setup_totals.read(("setup.kernels_load", "setup.kernels_build"))
