"""The program's spans in a traced run without a reader of their own:
``trace.summarize`` keeps them out of what it counts as work on the card;
and the three readers of the program's set-up totals (``setup_totals.py``)."""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import trace
from benchmark.cell import ROOT, load_reader
from paddle_lite_tpu_torch.core import trace as program_trace

SETUP_READERS = {"setup.kernels_s": ("setup.kernels_load", "setup.kernels_build"),
                 "setup.calibrate_s": ("setup.calibrate",),
                 "setup.capture_s": ("setup.warm_up", "setup.capture")}


def _ev(name, s, e, cuda=False, user=False):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt, is_user_annotation=user,
                           time_range=SimpleNamespace(start=s, end=e))


def _base():
    """A window of 100-1100 us: device busy 100-200, 300-400, 700-800."""
    return [_ev(trace.WINDOW_SPAN, 100, 1100), _ev(trace.WINDOW_SPAN, 100, 1100, True, True),
            _ev("cudaGraphLaunch", 210, 230), _ev("cudaEventSynchronize", 420, 690),
            _ev("int8_gemm_kernel", 90, 200, True), _ev("dw_conv_kernel", 300, 400, True),
            _ev("Memcpy DtoD (Device -> Device)", 700, 800, True)]


def _program():
    """The program's spans over `_base`, on the host and mirrored on the
    card's timeline as user annotations (as the profiler records a
    ``RecordFunction`` whose region launched work)."""
    return [_ev("plt.predictor.run", 150, 260, user=True),
            _ev("plt.graph.replay", 205, 240, user=True),
            _ev("plt.predictor.run", 600, 1200, user=True),
            _ev("plt.predictor.run", 150, 260, True, True),
            _ev("plt.graph.replay", 205, 240, True, True)]


def test_summarize_counts_no_program_span_as_work_on_the_card():
    base = trace.summarize(_base())
    got = trace.summarize(_base() + _program())
    for key in ("window_s", "busy_s", "kernels", "copies", "device_ops"):
        assert got[key] == base[key], key
    for key in ("kernels", "copies"):
        assert not [n for n in got[key] if n.startswith(program_trace.PREFIX)]
    # a gap begun inside a span and no op of the host's is the span's
    assert dict(got["idle_gaps"]) == {"plt.predictor.run": pytest.approx(100e-6 + 300e-6),
                                      "host: no op": pytest.approx(300e-6)}


@pytest.mark.parametrize("name", sorted(SETUP_READERS))
def test_setup_readers(name, monkeypatch):
    read = load_reader(ROOT, name)
    program_trace.reset()
    try:
        assert read(None) is None
        for i, key in enumerate(SETUP_READERS[name]):
            monkeypatch.setitem(program_trace.totals, key, [0.25 * (i + 1), 1])
        monkeypatch.setitem(program_trace.totals, "setup.optimize", [9.0, 2])
        want = sum(0.25 * (i + 1) for i in range(len(SETUP_READERS[name])))
        assert read(None) == pytest.approx(want)
        # a program without core.trace (the parent of its spans)
        monkeypatch.delattr(sys.modules["paddle_lite_tpu_torch.core"], "trace")
        monkeypatch.setitem(sys.modules, "paddle_lite_tpu_torch.core.trace", None)
        assert read(None) is None
    finally:
        program_trace.reset()
