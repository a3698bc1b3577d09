"""The compiled request path: ``compile_graph`` (a CUDA graph on the card,
the same static-buffer contract eagerly on the CPU) against the reference's
``compile_graph`` (``jax.jit``), and its contract.

Sizes as in test_torch_main_path.py (MobileNetV1 width 0.25, b2 / 32 px).
Tolerances, and why:
- the port's compiled function against its own eager loop on the CPU:
  equal (the same ops on the same inputs, in the same order);
- against the reference's jitted function on the same optimized graph:
  the softmax within 1e-3 (``testing.SOFTMAX_ATOL``, the bound of
  test_torch_main_path.py: the fp32 stem conv sums in another order in
  XLA, and a requant tie it flips moves the layers after it).
"""

import threading

import numpy as np
import pytest
import torch

import jax

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core import executor
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1 as p_mnv1
from paddle_lite_tpu_torch.models import mobilenet_v3 as p_mnv3
from paddle_lite_tpu_torch.models import ssd as p_ssd
from paddle_lite_tpu_torch.ops.kernels import nms
from paddle_lite_tpu_torch.runtime.predictor import Predictor, create_predictor
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
KW = dict(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
SHAPE = (2, 32, 32, 3)


def _feed(seed, shape=SHAPE):
    return {"image": np.random.default_rng(seed).normal(size=shape).astype(np.float32)}


@pytest.fixture(scope="module")
def ref_graph():
    gr = r_mnv1.build(**KW)
    r_optimize(gr, quant=R.QuantConfig(), calib_batches=[_feed(1), _feed(2)])
    return gr


@pytest.fixture(scope="module")
def port_graph():
    g = p_mnv1.build(**KW)
    optimize(g, quant=P.QuantConfig(), calib_batches=[_feed(1)], device="cpu")
    return g


def test_compile_graph_is_exported():
    assert P.compile_graph is executor.compile_graph
    assert "compile_graph" in dir(P)


@pytest.mark.parametrize("ref_tag", ["pallas", "xla"])
def test_compile_graph_matches_reference(ref_graph, ref_tag):
    """One optimized graph through both packages' compile_graph: the
    reference's jitted function (Pallas kernels in interpret mode, or XLA)
    and the port's ("cuda" tags take the plain versions on the CPU)."""
    gr = ref_graph
    for op in gr.ops:
        if op.attrs.get("kernel") in ("xla", "pallas"):
            op.attrs["kernel"] = ref_tag
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    feeds = [_feed(3), _feed(4)]
    r_fn, r_w = R.compile_graph(gr)
    fn, w = P.compile_graph(gp, device=CPU)
    eager = P.build_callable(gp, device=CPU)
    out = gr.outputs[0]
    for feed in feeds:
        want = np.asarray(jax.device_get(r_fn(r_w, feed))[out])
        got = fn(w, feed)[out]
        assert torch.equal(got, eager(w, feed)[out])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=testing.SOFTMAX_ATOL)


def test_outputs_are_fresh(port_graph):
    fn, w = P.compile_graph(port_graph, device=CPU)
    out = port_graph.outputs[0]
    first = fn(w, _feed(5))[out]
    kept = first.clone()
    second = fn(w, _feed(6))[out]
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr()


def test_an_output_that_aliases_an_input_is_fresh():
    """A graph whose output is a view of its input: the static input buffer
    is written by the next call, the result handed out is not."""
    b = P.GraphBuilder("alias", seed=0)
    x = b.input("x", (2, 3))
    b.mark_output(b.reshape(x, (3, 2)))
    g = b.build()
    fn, w = P.compile_graph(g, device=CPU)
    a = fn(w, {"x": np.ones((2, 3), np.float32)})[g.outputs[0]]
    fn(w, {"x": np.zeros((2, 3), np.float32)})
    assert torch.equal(a, torch.ones(3, 2))


def test_signature_checks(port_graph):
    g = port_graph
    fn, w = P.compile_graph(g, device=CPU)
    feed = _feed(7)
    out = g.outputs[0]
    ref = fn(w, feed)[out]
    # the same tensors in another dict are the same weights
    assert torch.equal(fn(dict(w), feed)[out], ref)
    with pytest.raises(ValueError, match="other weights"):
        fn({k: v.clone() for k, v in w.items()}, feed)
    with pytest.raises(ValueError, match="other weights"):
        fn({k: v for k, v in w.items() if k != next(iter(w))}, feed)
    with pytest.raises(ValueError, match="shape"):
        fn(w, {"image": np.zeros((1, 32, 32, 3), np.float32)})
    with pytest.raises(ValueError, match="missing"):
        fn(w, {})
    # another dtype is cast into the static buffer, as build_callable casts
    f64 = {"image": feed["image"].astype(np.float64)}
    assert torch.equal(fn(w, f64)[out], ref)
    assert torch.equal(fn(w, {"image": torch.from_numpy(feed["image"])})[out], ref)


def _tiny_ssd():
    g = p_ssd.build(batch=1, image_size=160, num_classes=3, seed=0)
    optimize(g, device="cpu")
    return g


def test_host_syncing_impl_is_rejected_before_capture():
    assert OPS.get("multiclass_nms").syncs_host("torch")
    assert OPS.get("multiclass_nms2").syncs_host("torch")
    assert not OPS.get("multiclass_nms").syncs_host("cuda")
    assert not OPS.get("conv2d").syncs_host(None)
    g = _tiny_ssd()
    assert executor.host_syncing_ops(g) == []
    bad = testing.retag(g, "cuda", "torch")
    assert [s.split()[0] for s in executor.host_syncing_ops(bad)] == ["multiclass_nms"]
    with pytest.raises(ValueError, match="multiclass_nms.*'torch'"):
        P.compile_graph(bad, device=CPU)
    with pytest.raises(ValueError, match="multiclass_nms"):
        Predictor(bad, device="cpu")
    # the eager loop still runs it
    out = P.build_callable(bad, device=CPU)(P.stage_weights(bad, CPU),
                                            _feed(8, (1, 160, 160, 3)))
    assert out[g.outputs[0]].shape == (1, 100, 6)


def test_clone_has_its_own_buffers(port_graph):
    g = port_graph
    pred = Predictor(g, device="cpu")
    feed = _feed(9)
    ref = pred.run(feed)[g.outputs[0]]
    clones = [pred.clone() for _ in range(4)]
    for c in clones:
        assert c._weights is pred._weights and c._fn.weights is pred._fn.weights
        assert c._fn.ctx is pred._fn.ctx  # the filled per-op constants
        assert c._fn is not pred._fn
        assert c._fn._inputs["image"].data_ptr() != pred._fn._inputs["image"].data_ptr()
    outs, errors = [None] * 4, []

    def work(i):
        try:
            outs[i] = [clones[i].run(_feed(10 + i))[g.outputs[0]] for _ in range(3)]
        except Exception as e:  # reported below
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in ts)
    for i, o in enumerate(outs):
        want = pred.run(_feed(10 + i))[g.outputs[0]]
        assert all(torch.equal(x, want) for x in o)
    assert torch.equal(pred.run(feed)[g.outputs[0]], ref)


class _HostRoundTrip(AssertionError):
    pass


@pytest.fixture
def no_host_round_trips(monkeypatch):
    """While on, every call that would read a tensor back to the host on a
    card (``item``, ``bool``, ``int``, ``float``, ``tolist``, ``torch.equal``)
    or copy a host array to it (``torch.from_numpy`` of a non-empty array)
    raises: a CPU stand-in for the card's ``set_sync_debug_mode("error")``."""
    state = {"on": False}

    def guard(name, real):
        def f(*a, **kw):
            if state["on"]:
                raise _HostRoundTrip(name)
            return real(*a, **kw)
        return f

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "equal", guard("torch.equal", torch.equal))
    real_from_numpy = torch.from_numpy

    def from_numpy(a):
        if state["on"] and a.size:
            raise _HostRoundTrip("torch.from_numpy")
        return real_from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    # the NMS kernel's plain version (the CPU's stand-in for it) reads
    # torch.equal back each round; on the card the kernel runs instead
    real_plain = nms.nms_keep_scores_plain

    def plain(*a, **kw):
        on, state["on"] = state["on"], False
        try:
            return real_plain(*a, **kw)
        finally:
            state["on"] = on

    monkeypatch.setattr(nms, "nms_keep_scores_plain", plain)
    return state


@pytest.mark.parametrize("path", ["mobilenet_v1", "mobilenet_v1_fused", "mobilenet_v3", "ssd"])
def test_request_path_has_no_host_round_trip_after_warm_up(path, no_host_round_trips):
    """Every op of the four int8 paths, after the warm-up has filled the
    per-op constants: no value read back, no host array copied over."""
    if path == "ssd":
        g, shape = p_ssd.build(batch=1, image_size=160, num_classes=3, seed=0), (1, 160, 160, 3)
    elif path == "mobilenet_v3":
        g = p_mnv3.build(batch=2, image_size=64, num_classes=10, seed=5, with_softmax=False)
        shape = (2, 64, 64, 3)
    else:
        g, shape = p_mnv1.build(**KW), SHAPE
    quant = P.QuantConfig(fuse_dw_pw=path.endswith("fused"))
    pred = create_predictor(g, quant=quant, calib_batches=[_feed(1, shape)], device="cpu")
    x = torch.from_numpy(_feed(2, shape)["image"])
    want = pred.run({"image": x})[g.outputs[0]]
    no_host_round_trips["on"] = True
    try:
        got = pred._fn(pred._weights, {"image": x})[g.outputs[0]]
    finally:
        no_host_round_trips["on"] = False
    assert torch.equal(got, want)
