"""setup_s (s): process start to the first timed request, on the host clock:
imports, the kernel libraries' load (and, in a checkout's first run, their
build), weights, calibration, quantization, warm-up and capture."""


def read(r):
    return r.setup_s
