"""The frozen op-cost arithmetic against hand counts, and the step metrics
on a tiny graph."""

from types import SimpleNamespace

import pytest

from benchmark import costs
from benchmark.cell import ROOT, load_reader

H100 = costs.PEAKS["h100 80gb hbm3"]


@pytest.fixture
def graph():
    from paddle_lite_tpu_torch.core.builder import GraphBuilder

    b = GraphBuilder("tiny", seed=0)
    x = b.input("image", (2, 8, 8, 4))
    c = b.conv2d(x, 6, 3, padding=1, name="conv")
    d = b.conv2d(c, 6, 3, stride=2, padding=1, depthwise=True, name="dw")
    r = b.reshape(d, (2, 96))
    f = b.fc(r, 10, name="fc")
    y = b.weight("y", b.rng.normal(size=(10, 5)).astype("float32"))
    m = b.op("matmul", {"X": [f], "Y": [y]}, shape_args=[f, y])[0]
    b.mark_output(m)
    return b.build()


def _op(graph, op_type):
    return next(op for op in graph.ops if op.op_type == op_type)


def test_conv_cost(graph):
    c = costs.op_cost(graph, _op(graph, "conv2d"), H100)
    assert c["flops"] == 2 * (2 * 8 * 8 * 6) * (3 * 3 * 4)
    assert c["bytes"] == 4 * (2 * 8 * 8 * 4 + 3 * 3 * 4 * 6 + 2 * 8 * 8 * 6)
    assert c["compute_s"] == c["flops"] / H100["fp32_ops"]
    assert c["bound_s"] == max(c["bytes"] / H100["hbm_bytes"], c["compute_s"])


def test_depthwise_cost(graph):
    op = _op(graph, "depthwise_conv2d")
    c = costs.op_cost(graph, op, H100)
    assert c["flops"] == 2 * (2 * 4 * 4 * 6) * (3 * 3 * 1)
    assert c["bytes"] == 4 * (2 * 8 * 8 * 6 + 3 * 3 * 1 * 6 + 2 * 4 * 4 * 6)
    op.attrs.update(enable_int8=True, out_scale=0.1)
    assert costs.op_cost(graph, op, H100)["compute_s"] == c["flops"] / H100["int8_ops"]
    # one launch of the int8 kernel: int8 in, weights and out, fp32 scales
    want = (2 * 8 * 8 * 6 + 3 * 3 * 6 + 4 * 6 + 2 * 4 * 4 * 6) / H100["hbm_bytes"]
    assert costs.dw_cost(graph, op, H100) == max(want, c["flops"] / H100["int8_ops"])


def test_fc_cost(graph):
    op = _op(graph, "fc")
    c = costs.op_cost(graph, op, H100)
    assert c["flops"] == 2 * 2 * 10 * 96
    assert c["bytes"] == 4 * (2 * 96 + 96 * 10 + 10 + 2 * 10)
    assert costs.gemm_mkn(graph, op) == (2, 96, 10)
    # fp32 out (no requant), a bias: A, B, scales, bias, C
    nbytes = 2 * 96 + 96 * 10 + 4 * 10 * 2 + 4 * 2 * 10
    assert costs.gemm_cost(graph, op, H100) == max(
        2 * 2 * 96 * 10 / H100["int8_ops"], nbytes / H100["hbm_bytes"])


def test_matmul_cost(graph):
    c = costs.op_cost(graph, _op(graph, "matmul"), H100)
    assert c["flops"] == 2 * (2 * 5) * 10
    assert c["bytes"] == 4 * (2 * 10 + 10 * 5 + 2 * 5)


def test_conv_as_gemm(graph):
    op = _op(graph, "conv2d")
    assert costs.gemm_mkn(graph, op) == (2 * 8 * 8, 3 * 3 * 4, 6)


def test_step_metrics(graph):
    r = SimpleNamespace(graph=graph, peaks=H100,
                        trace={"calls": 10, "window_s": 0.5})
    ops = graph.topological_order()
    compute = sum(costs.op_cost(graph, op, H100)["compute_s"] for op in ops)
    bound = sum(costs.op_cost(graph, op, H100)["bound_s"] for op in ops)
    assert load_reader(ROOT, "step.mfu")(r) == pytest.approx(100 * compute * 10 / 0.5)
    assert load_reader(ROOT, "step.roofline_share")(r) == pytest.approx(100 * bound * 10 / 0.5)
    assert bound > compute > 0
    r.trace = None
    assert load_reader(ROOT, "step.mfu")(r) is None


def test_gemm_roofline_needs_launches(graph):
    op = _op(graph, "fc")
    op.attrs.update(kernel="cuda", enable_int8=True)
    read = load_reader(ROOT, "kernels.gemm_roofline")
    r = SimpleNamespace(graph=graph, peaks=H100,
                        trace={"calls": 4, "window_s": 1.0, "kernels": {}})
    with pytest.raises(RuntimeError, match="int8_gemm_kernel"):
        read(r)
    r.trace["kernels"] = {"void int8_gemm_kernel<64, 2, 1>(...)": [4, 1e-3]}
    assert read(r) == pytest.approx(100 * costs.gemm_cost(graph, op, H100) * 4 / 1e-3)


def test_unknown_card():
    with pytest.raises(KeyError):
        costs.peaks_for("NVIDIA A100-SXM4-80GB")
