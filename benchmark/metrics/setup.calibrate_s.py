"""setup.calibrate_s (s): the process's ``setup.calibrate`` total
(``core/trace.snapshot()``): PTQ's calibration runs of the fp32 graph
(``quant/calibrate.calibrate``), less the weights it stages; the passes
of ``tools/opt`` around it left out."""

from benchmark import setup_totals


def read(r):
    return setup_totals.read(("setup.calibrate",))
