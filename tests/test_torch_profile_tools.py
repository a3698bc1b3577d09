"""The profile and report tools of the port, held to the JAX package on the
CPU: ``tools/profile`` (``_isotonic_fit``, ``latency_report``,
``per_type_summary``, ``_main``), ``tools/roofline_report``,
``tools/gemm_roofline``'s shapes, ``utils/device_info`` and ``tools/trace``.

- ``_isotonic_fit``: the reference's on seeded noisy curves, equal to the
  last bit (the same pool-adjacent-violators arithmetic).
- ``latency_report`` on the CPU (a host clock: the numbers are not device
  times; the card's are chip_smoke phase 15d's): the reference's row keys,
  one row a prefix, and the fitted per-op ``ms`` summing to the last
  ``cum_ms_fit`` exactly (within 1e-12 of float rounding).  These run with
  a zero window: a host clock beside the suite's other workers is noisy
  enough that a window's loop can grow for minutes, and the tests check
  the rows, not the times.
- ``roofline_report``: each op's bytes and operations equal the
  reference's untiled ones on the reference-optimized graph carried across
  (MobileNetV1 int8 and ERNIE-tiny with bf16 islands).
- ``gemm_roofline.gemm_shapes``: the GEMM shapes chip_smoke's
  ``kernel_shapes`` reads off the same graph.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.tools import profile as r_profile
from paddle_lite_tpu.tools import roofline_report as r_roof
from paddle_lite_tpu_torch.formats import interop
from paddle_lite_tpu_torch.models import mobilenet_v1
from paddle_lite_tpu_torch.tools import gemm_roofline, profile, roofline_report, trace
from paddle_lite_tpu_torch.tools.opt import optimize
from paddle_lite_tpu_torch.utils import device_info

ROW_KEYS = {"op", "id", "k", "n_ops", "cum_ms", "ms_raw", "loop", "cum_ms_fit", "ms"}


@pytest.mark.parametrize("seed", range(6))
def test_isotonic_fit_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    curve = np.cumsum(rng.uniform(0, 1, n)) + rng.normal(0, 0.8, n)
    xs = [float(v) for v in curve]
    got = profile._isotonic_fit(xs)
    assert got == r_profile._isotonic_fit(xs)
    assert all(b >= a for a, b in zip(got, got[1:]))



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    and PyTorch's default of one thread a core each oversubscribes them
    (a timing test here then ran for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_mnv1():
    rng = np.random.default_rng(0)
    g = mobilenet_v1.build(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
    feed = profile.model_feed(g)
    optimize(g, quant=P.QuantConfig(), calib_batches=[
        {"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)}], device="cpu")
    return g, feed


def test_latency_report_rows_and_the_telescoping_sum():
    g, feed = _tiny_mnv1()
    n = len(g.ops)
    seen = []
    rows = profile.latency_report(g, feed, min_window=0.0, reps=1, ks=[2, 9, n], device="cpu",
                                  progress=seen.append)
    assert [r["k"] for r in rows] == [2, 9, n] and [r["n_ops"] for r in rows] == [2, 7, n - 9]
    assert all(set(r) == ROW_KEYS for r in rows) and seen == rows
    order = g.topological_order()
    assert [(r["op"], r["id"]) for r in rows] == [(order[k - 1].op_type, order[k - 1].id)
                                                  for k in (2, 9, n)]
    assert sum(r["ms"] for r in rows) == pytest.approx(rows[-1]["cum_ms_fit"], abs=1e-12)
    assert all(r["ms"] >= 0 for r in rows)
    summary = profile.per_type_summary(rows)
    assert sum(t["ms"] for t in summary) == pytest.approx(rows[-1]["cum_ms_fit"], abs=1e-12)
    assert [t["ms"] for t in summary] == sorted((t["ms"] for t in summary), reverse=True)


def test_profile_main_writes_the_fitted_rows(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "p.jsonl")
    monkeypatch.setattr("sys.argv", ["profile", "--model", "mobilenet_v1", "--batch", "1",
                                     "--image-size", "32", "--fp32", "--min-window", "0",
                                     "--device", "cpu", "--out", out])
    profile._main()
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(set(r) == ROW_KEYS for r in rows)
    assert "per-type (sums to the whole-model prefix" in capsys.readouterr().out


def _reference_optimized(model):
    """The reference's optimized graph of `model` (small) and the port's
    copy of it, carried across by the shared meta."""
    rng = np.random.default_rng(1)
    if model == "ernie":
        from paddle_lite_tpu.models import ernie_tiny

        rg = ernie_tiny.build(batch=2, seq_len=16, hidden=64, n_layers=2, n_heads=4,
                              ffn_dim=128, vocab_size=100, seed=0)
        feed = {"token_ids": rng.integers(0, 100, (2, 16)).astype(np.int32),
                "segment_ids": np.zeros((2, 16), np.int32)}
        quant = R.QuantConfig(island_dtype="bfloat16")
    else:
        from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1

        rg = r_mnv1.build(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
        feed = {"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)}
        quant = R.QuantConfig()
    from paddle_lite_tpu.tools.opt import optimize as r_optimize

    r_optimize(rg, quant=quant, calib_batches=[feed])
    return rg, interop.graph_from_reference(r_artifact.graph_to_meta(rg), rg.weights)


@pytest.mark.parametrize("model", ["mobilenet_v1", "ernie"])
def test_roofline_bytes_and_operations_are_the_reference(model):
    rg, g = _reference_optimized(model)
    island = rg.meta.get("island_dtype") == "bfloat16"
    want = [r_roof._op_cost(rg, op, island, tiled=False)[:2] for op in rg.topological_order()]
    got = [roofline_report._op_cost(g, op, island)[:2] for op in g.topological_order()]
    assert got == want and any(f for _, f in got)
    rep = roofline_report.roofline_report(g)
    assert [r["op"] for r in rep["per_op"]] == [op.op_type for op in g.topological_order()]
    ref = r_roof.roofline_report(rg)
    assert [(r["traffic_mb"], r["gflops"]) for r in rep["per_op"]] == \
        [(r["traffic_mb"], r["gflops"]) for r in ref["per_op"]]


def test_roofline_joins_a_profile():
    g, feed = _tiny_mnv1()
    rows = profile.latency_report(g, feed, min_window=0.0, reps=1, ks=[3, len(g.ops)],
                                  device="cpu")
    rep = roofline_report.roofline_report(g, profile={r["id"]: r for r in rows})
    joined = [r for r in rep["per_op"] if "measured_ms" in r]
    assert [r["id"] for r in joined] == [r["id"] for r in rows]
    assert all("x_off_roofline" in v for v in rep["by_op_type"].values())


def test_gemm_shapes_are_chip_smokes():
    g, _ = _tiny_mnv1()
    want = []
    for m, k, n, i8, *_ in chip_smoke.kernel_shapes(g)[0]:
        if (m, k, n, i8) not in want:
            want.append((m, k, n, i8))
    assert gemm_roofline.gemm_shapes(g) == want and want


def test_device_info_cpu_entry_and_unknown_cards():
    info = device_info.get("cpu")
    assert info.platform == "cpu" and info.specs is device_info.SPECS["cpu"]
    assert info.roofline_time_s(1e12, 0.0) == pytest.approx(1.0)
    assert device_info.memory_stats("cpu") is None
    h100 = device_info.specs_for("NVIDIA H100 80GB HBM3")
    assert (h100["hbm_gbps"], h100["int8_tops"], h100["bf16_tflops"]) == (3350.0, 1979.0, 989.0)
    assert h100["fp32_tinstrs"] * 1e12 == pytest.approx(132 * 128 * 1.98e9)
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "Tesla T4"):
        with pytest.raises(KeyError, match="no figures"):
            device_info.specs_for(name)
    assert chip_smoke.HBM_BYTES_PER_S == h100["hbm_gbps"] * 1e9
    assert chip_smoke.INT8_TC_OPS_PER_S == h100["int8_tops"] * 1e12


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with trace.trace(str(tmp_path)) as t:
        with trace.annotate("matmul"):
            (x @ x).sum()
    assert os.path.getsize(t.path) > 0
    with open(t.path) as f:
        assert "matmul" in f.read()
