"""The AOT export, the checkpoint and the program dumps of the port, held to
the JAX package on the CPU.

- ``formats/aot``: the reference's ``tests/test_aot_and_dump.py::_model``
  graph (optimized by the reference, carried across) exported with
  ``torch.export`` and loaded back: the loaded program's output equals the
  port's ``Predictor`` bit for bit and the reference's own ``aot`` round
  trip within that test's rtol 1e-5 / atol 1e-6 (the fc's fp32 epilogue).
  A small SSD exports with its kernels as ``plt::`` custom ops (the loaded
  program equal to ``Predictor`` bit for bit); a graph with a host-syncing
  impl is refused with ``compile_graph``'s message, in a control-flow
  block too, naming the op (control flow itself exports:
  ``tests/test_torch_aot_control_flow.py``).
- ``formats/torch_ckpt``: a round trip gives the same graph meta, weights and
  outputs, bit for bit.
- ``tools/dump``: ``dump_dot`` and ``dump_graph`` are the reference's
  strings for the same graph, ``dump_graph``'s kernel tags in each
  package's vocabulary (``"pallas"`` / ``"xla"`` there, ``"cuda"`` /
  ``"torch"`` here).
"""

import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import aot as r_aot
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.tools import dump as r_dump
from paddle_lite_tpu_torch.formats import aot, artifact, interop, torch_ckpt
from paddle_lite_tpu_torch.models import mobilenet_v1, ssd
from paddle_lite_tpu_torch.runtime.predictor import Predictor, create_predictor
from paddle_lite_tpu_torch.testing import retag
from paddle_lite_tpu_torch.tools import dump
from test_aot_and_dump import _model as reference_model

REF_RTOL, REF_ATOL = 1e-5, 1e-6  # tests/test_aot_and_dump.py's



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    and PyTorch's default of one thread a core each oversubscribes them
    (a timing test here then ran for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(rg):
    return interop.graph_from_reference(r_artifact.graph_to_meta(rg), rg.weights)


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _plt_ops(run) -> set:
    return {str(n.target) for n in run.program.graph.nodes if str(n.target).startswith("plt.")}


def test_export_of_the_reference_model(tmp_path):
    rng = np.random.default_rng(0)
    rg = reference_model(rng)
    feed = {"x": rng.normal(size=(2, 8, 8, 8)).astype(np.float32)}
    path = str(tmp_path / "model.stablehlo")
    r_aot.save_compiled(rg, path)
    want = np.asarray(r_aot.load_compiled_file(path)(feed)[rg.outputs[0]])

    g = _carried(rg)
    pred = Predictor(g, device="cpu")
    aot.save_compiled(g, str(tmp_path / "model.pt2"), device="cpu")
    run = aot.load_compiled_file(str(tmp_path / "model.pt2"))
    got = run(feed)
    assert _equal(got, pred.run(feed))
    np.testing.assert_allclose(got[g.outputs[0]].numpy(), want, rtol=REF_RTOL, atol=REF_ATOL)
    # the reference's kernel pick leaves this small fc on "xla" (its TPU size
    # gate), so the carried graph runs it on "torch": no custom op
    tagged = {op.op_type for op in g.ops if op.attrs.get("kernel") == "cuda"}
    assert _plt_ops(run) == ({"plt.int8_gemm.default"} if tagged else set())
    assert run.meta["inputs"] == {"x": {"shape": [2, 8, 8, 8], "dtype": "float32"}}
    # a tensor input in another dtype is cast, as Predictor casts it
    assert _equal(run({"x": torch.from_numpy(feed["x"]).double()}), got)


def _small_ssd():
    rng = np.random.default_rng(2)
    g = ssd.build(batch=1, image_size=160, num_classes=3, seed=0)
    x = {"image": rng.normal(size=(1, 160, 160, 3)).astype(np.float32)}
    pred = create_predictor(g, quant=P.QuantConfig(), calib_batches=[x], device="cpu")
    return g, pred, {"image": rng.normal(size=(1, 160, 160, 3)).astype(np.float32)}


def test_ssd_exports_its_kernels_as_custom_ops():
    g, pred, feed = _small_ssd()
    run = aot.load_compiled(aot.export_compiled(g, device="cpu"))
    # the 3x3 convs gather their rows inside the GEMM: one plt::int8_conv each
    assert _plt_ops(run) == {"plt.int8_gemm.default", "plt.int8_conv.default",
                             "plt.dw_conv.default", "plt.nms_keep.default"}
    assert _equal(run(feed), pred.run(feed))
    text = dump.dump_exported(g, device="cpu")
    assert "plt.nms_keep.default" in text and "plt.int8_gemm.default" in text
    assert "plt.int8_conv.default" in text


def test_residual_conv_exports_its_residual_into_the_gemm_op():
    """A shortcut add fused into an int8 conv (``ResidualData``) exports as
    one ``plt::int8_gemm`` op that takes the residual, and the loaded
    program gives the predictor's output bit for bit."""
    from paddle_lite_tpu_torch.core.builder import GraphBuilder

    b = GraphBuilder("residual", seed=4)
    x = b.conv_bn_act(b.input("x", (1, 8, 8, 16)), 16, 1, act="relu")
    a = b.conv_bn_act(x, 32, 1, act="relu")
    y = b.batch_norm(b.conv2d(a, 16, 1))
    b.mark_output(b.act(b.eltwise(y, x, "add"), "relu"))
    g = b.build()
    rng = np.random.default_rng(5)
    feed = {"x": rng.normal(size=(1, 8, 8, 16)).astype(np.float32)}
    pred = create_predictor(g, quant=P.QuantConfig(), calib_batches=[feed], device="cpu")
    convs = [o for o in g.ops if o.op_type == "conv2d"]
    assert [bool(o.maybe_input("ResidualData")) for o in convs].count(True) == 1
    assert all(o.attrs.get("kernel") == "cuda" for o in convs)
    run = aot.load_compiled(aot.export_compiled(g, device="cpu"))
    gemms = [n for n in run.program.graph.nodes if str(n.target) == "plt.int8_gemm.default"]
    assert len(gemms) == 3 and sum(n.args[8] is not None for n in gemms) == 1
    assert _equal(run(feed), pred.run(feed))


def test_a_syncing_graph_is_refused():
    g, _, _ = _small_ssd()
    with pytest.raises(ValueError, match="compile_graph: multiclass_nms.*'torch'"):
        aot.export_compiled(retag(g, "cuda", "torch"), device="cpu")


def test_control_flow_is_refused_naming_the_op():
    """Control flow exports (``tests/test_torch_aot_control_flow.py``); a
    block holding an op that syncs with the host does not, and the refusal
    names that op: here the ``"torch"`` NMS inside a while body."""
    inner = P.GraphBuilder("nms_body")
    inner.input("c_in", (1,), precision=P.Precision.BOOL)
    bx = inner.input("b_in", (1, 8, 4))
    sc = inner.input("s_in", (1, 8, 2))
    inner.op("multiclass_nms", {"BBoxes": [bx], "Scores": [sc]}, attrs={"keep_top_k": 8},
             shape_args=[bx, sc])
    inner.mark_output("c_in", bx, sc)
    b = P.GraphBuilder("outer")
    c = b.input("c", (1,), precision=P.Precision.BOOL)
    bx = b.input("b", (1, 8, 4))
    sc = b.input("s", (1, 8, 2))
    outs = b.op("while", {"X": [c, bx, sc]}, attrs={"block": inner.build()},
                shape_args=[c, bx, sc], out_slots=("Out",),
                out_precisions=[P.Precision.BOOL, P.Precision.FP32, P.Precision.FP32])
    b.mark_output(outs[1])
    with pytest.raises(ValueError, match=r"compile_graph: multiclass_nms \(kernel 'torch'"):
        aot.export_compiled(b.build(), device="cpu")


def test_torch_ckpt_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    g = mobilenet_v1.build(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
    x = {"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)}
    pred = create_predictor(g, quant=P.QuantConfig(weight_only=4), device="cpu")
    want = pred.run(x)
    torch_ckpt.save(g, str(tmp_path / "ckpt"))
    g2 = torch_ckpt.load(str(tmp_path / "ckpt"))
    assert artifact.graph_to_meta(g2) == artifact.graph_to_meta(g)
    assert set(g2.weights) == set(g.weights)
    for k, v in g.weights.items():
        assert g2.weights[k].dtype == v.dtype and np.array_equal(g2.weights[k], v)
    assert _equal(Predictor(g2, device="cpu").run(x), want)


def _reference_tags(text: str) -> str:
    return text.replace("k=cuda", "k=pallas").replace("k=torch", "k=xla")


def _dump_model(pkg, optimize):
    """tests/test_aot_and_dump.py's _model in package `pkg` (R or P), its
    optimize run with the same calibration batch when asked."""
    rng = np.random.default_rng(0)
    b = pkg.GraphBuilder("m", seed=71)
    x = b.input("x", (2, 8, 8, 8))
    y = b.conv_bn_act(x, 16, 1, act="relu")
    y = b.pool2d(y, "avg", global_pooling=True)
    b.mark_output(b.fc(b.reshape(y, (2, 16)), 4))
    g = b.build()
    if optimize is not None:
        calib = [{"x": rng.normal(size=(2, 8, 8, 8)).astype(np.float32)}]
        optimize(g, quant=pkg.QuantConfig(), calib_batches=calib)
    return g


@pytest.mark.parametrize("optimized", [False, True])
def test_dumps_are_the_reference_strings(optimized):
    """dump_dot of the graph each package builds and optimizes (the same
    ops, ids and precisions; a dot dump names no kernel tag), and dump_graph
    of the reference's graph carried across (the same tags, each in its
    package's vocabulary; the port's own kernel pick tags more ops
    "cuda" than the reference's TPU size gates tag "pallas")."""
    from paddle_lite_tpu.tools.opt import optimize as r_optimize
    from paddle_lite_tpu_torch.tools.opt import optimize as p_optimize

    rg = _dump_model(R, r_optimize if optimized else None)
    g = _dump_model(P, (lambda g, **kw: p_optimize(g, device="cpu", **kw))
                    if optimized else None)
    assert dump.dump_dot(g) == r_dump.dump_dot(rg)
    assert ("int8" in dump.dump_dot(g)) == optimized
    assert _reference_tags(dump.dump_graph(_carried(rg))) == r_dump.dump_graph(rg)
