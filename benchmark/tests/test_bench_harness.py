"""The harness's data: every name in BENCHMARK.json finds its files, the
trace's reduction on made-up events, and the result line's shape."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import traffic, trace
from benchmark.cell import ROOT, Cell, load_json, load_reader, metrics_for

BENCH = load_json(ROOT / "BENCHMARK.json")


def test_every_name_has_its_files():
    for w in BENCH["workloads"]:
        cell = Cell(ROOT, w["name"])
        assert cell.mix["kind"] in traffic.KINDS
        assert set(cell.limits) == {"logit_rel_err", "own_vs_other"}
        assert cell.family.model(cell.cfg).params(cell.cfg)
        for fn in ("make", "inputs", "build", "feed", "answer", "Reference", "compare"):
            assert callable(getattr(cell.family, fn))
        e2e = metrics_for(BENCH, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert metrics_for(BENCH, w["name"], True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(load_reader(ROOT, m["name"]))


def _ev(name, s, e, cuda):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt,
                           time_range=SimpleNamespace(start=s, end=e))


def test_trace_reduction():
    events = [_ev(trace.WINDOW_SPAN, 100, 1100, False),
              _ev("Predictor.run", 90, 400, False), _ev("cudaGraphLaunch", 150, 160, False),
              _ev("sleep", 640, 1100, False),
              _ev("int8_gemm_kernel", 50, 200, True), _ev("int8_gemm_kernel", 250, 300, True),
              _ev("Memcpy HtoD (Pageable -> Device)", 280, 350, True),
              _ev("cudnn_conv", 600, 650, True), _ev("late", 1200, 1300, True),
              _ev(trace.WINDOW_SPAN, 100, 1100, True)]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    # [100, 200] + [250, 350] + [600, 650]
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["kernels"]["int8_gemm_kernel"] == [2, pytest.approx(150e-6)]
    assert list(s["copies"]) == ["Memcpy HtoD (Pageable -> Device)"]
    gaps = dict(s["idle_gaps"])
    # by what the host did as each gap began: 200-250 and 350-600 in
    # Predictor.run, 650-1100 in sleep
    assert gaps == {"Predictor.run": pytest.approx(300e-6), "sleep": pytest.approx(450e-6)}
    assert s["device_ops"][0][0] == "int8_gemm_kernel"


def test_own_vs_other_tells_inputs_apart():
    from benchmark.families import cnn_int8

    g = torch.Generator().manual_seed(3)
    pool = torch.softmax(3 * torch.randn(6, 50, generator=g, dtype=torch.float64), -1)
    idx = torch.arange(6)
    noisy = torch.softmax(torch.log(pool) + 0.05 * torch.randn(6, 50, generator=g,
                                                               dtype=torch.float64), -1)
    sound = cnn_int8.compare(noisy, pool, idx)
    assert float(sound["own_vs_other"].max()) < 0.2
    swapped = cnn_int8.compare(noisy[[1, 0, 2, 3, 4, 5]], pool, idx)
    assert float(swapped["own_vs_other"][:2].min()) > 5
    assert torch.equal(swapped["logit_rel_err"][2:], sound["logit_rel_err"][2:])
