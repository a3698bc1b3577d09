"""Control flow in the port: ``while``, ``conditional_block`` and
``subgraph`` through ``compile_graph`` (on the card one CUDA graph, each
control-flow op conditional nodes in it, its block's ops inline in their
bodies) against the eager loop, the beam-search decode loop against the
reference, and the control-flow artifact both ways between the packages.

On the CPU the compiled path runs the same plan as on the card (one
segment, static state buffers, a device trip counter) without CUDA
graphs, the conditions read on the host, so these tests hold its logic;
``chip_smoke.py`` phase 14c holds the captured graph on the card.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu_torch import build_callable, compile_graph, stage_weights
from paddle_lite_tpu_torch.core.builder import GraphBuilder
from paddle_lite_tpu_torch.core.types import Precision
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.models import beam_decode
from paddle_lite_tpu_torch.runtime.predictor import Predictor, load_predictor
from paddle_lite_tpu_torch.testing import control_flow_graphs as cf_graphs
from paddle_lite_tpu_torch.testing import op_cases

CPU = torch.device("cpu")
SMALL = dict(batch=2, beam=2, hidden=8)


def _eager(g, feed):
    return build_callable(g, device=CPU)(stage_weights(g, CPU), feed)


def _assert_equal(a, b):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def _reference(g):
    rg = r_artifact.graph_from_meta(p_artifact.graph_to_meta(g))
    rg.weights = dict(g.weights)
    rg.rebuild_links()
    return rg


def _run_reference(rg, feed):
    weights = {k: jax.numpy.asarray(v) for k, v in R.stage_weights(rg).items()}
    out = R.build_callable(rg, platform="cpu")(weights, feed)
    return {n: np.asarray(jax.device_get(v)) for n, v in out.items()}


_cond_graph = cf_graphs.cond_graph
_block_with_while = cf_graphs.block_with_while


def _subgraph_graph(n: int = 3, c: int = 4):
    b = GraphBuilder("sub_outer")
    x = b.input("x", (n, c))
    y = b.op("subgraph", {"Inputs": [x]}, attrs={"graph": op_cases._affine_block((n, c))},
             shape_args=[x], out_slots=("Outputs",))[0]
    b.mark_output(b.act(y, "relu"))
    return b.build()


# ---- the compiled path against the eager loop ------------------------------------------

def test_compiled_while_equals_eager():
    g = beam_decode.build(vocab=50, steps=5, **SMALL)
    fn, w = compile_graph(g, device=CPU)
    for seed in (1, 2):  # the state is reset by every call
        feed = beam_decode.feed(seed=seed, **SMALL)
        _assert_equal(fn(w, feed), _eager(g, feed))
        assert [ex.trips for ex in fn.control_flow] == [5]
    assert fn.n_graphs == 0  # no CUDA graph on the CPU


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("nested_while", [False, True])
def test_compiled_conditional_block_equals_eager(flag, nested_while):
    g = _cond_graph(nested_while=nested_while)
    fn, w = compile_graph(g, device=CPU)
    feed = {"x": np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32),
            "flag": np.array([flag])}
    got = fn(w, feed)
    _assert_equal(got, _eager(g, feed))
    want = _run_reference(_reference(g), feed)
    np.testing.assert_allclose(got[g.outputs[0]].numpy(), want[g.outputs[0]],
                               rtol=1e-5, atol=1e-6)
    if nested_while:
        (cond,) = fn.control_flow
        assert [ex.trips for ex in cond.body.control_flow] == ([5] if flag else [0])


def test_compiled_subgraph_stays_inline():
    g = _subgraph_graph()
    fn, w = compile_graph(g, device=CPU)
    assert fn.control_flow == [] and len(fn._steps) == 1
    feed = {"x": np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)}
    _assert_equal(fn(w, feed), _eager(g, feed))


def test_compiled_block_outputs_never_alias_the_state():
    """A block output that shares storage with the state is copied, so
    writing the state back never reads a half-written one; the carried
    projection, passed through under its own name, is its state buffer
    itself and is neither copied out nor back."""
    g = beam_decode.build(vocab=50, steps=3, **SMALL)
    fn, w = compile_graph(g, device=CPU)
    feed = beam_decode.feed(**SMALL)
    fn(w, feed)
    (loop,) = fn.control_flow
    state = loop.body._inputs
    assert loop.body.carried == {"w_vocab_in"}
    out = loop.body(state)
    assert out["w_vocab_in"] is state["w_vocab_in"]
    for name, n in out.items():
        if name == "w_vocab_in":
            continue
        for s in state.values():
            assert n.untyped_storage().data_ptr() != s.untyped_storage().data_ptr()


_swap_graph = cf_graphs.swap_graph


def test_compiled_while_swaps_crossed_state():
    """State vars the block passes through under each other's names are
    not carried: each is copied out, so three swaps leave them swapped."""
    g = _swap_graph()
    fn, w = compile_graph(g, device=CPU)
    rng = np.random.default_rng(3)
    feed = {"a": rng.normal(size=(2, 3)).astype(np.float32),
            "b": rng.normal(size=(2, 3)).astype(np.float32)}
    got = fn(w, feed)
    (loop,) = fn.control_flow
    assert loop.body.carried == frozenset() and loop.trips == 3
    _assert_equal(got, _eager(g, feed))
    a_out, b_out = g.outputs
    np.testing.assert_array_equal(got[a_out].numpy(), feed["b"])
    np.testing.assert_array_equal(got[b_out].numpy(), feed["a"])


def test_control_flow_inside_a_subgraph_is_rejected():
    """A subgraph's region runs its ops' eager impls inline, so a while
    loop inside one would read its condition on the host in the capture:
    compile_graph names it before any capture."""
    b = GraphBuilder("sub_while")
    x = b.input("x", (3, 4))
    y = b.op("subgraph", {"Inputs": [x]}, attrs={"graph": _block_with_while((3, 4))},
             shape_args=[x], out_slots=("Outputs",))[0]
    b.mark_output(y)
    g = b.build()
    with pytest.raises(ValueError, match=r"while \(kernel"):
        compile_graph(g, device=CPU)
    feed = {"x": np.ones((3, 4), np.float32)}
    np.testing.assert_allclose(_eager(g, feed)[g.outputs[0]].numpy(),
                               np.full((3, 4), 0.5 + 0.5 ** 5 * 0.5, np.float32),
                               rtol=1e-6)


def test_a_syncing_op_inside_a_block_is_rejected():
    """Other host-syncing ops still raise, in a block too: here the
    ``"torch"`` NMS inside a while body."""
    inner = GraphBuilder("nms_body")
    inner.input("c_in", (1,), precision=Precision.BOOL)
    bx = inner.input("b_in", (1, 8, 4))
    sc = inner.input("s_in", (1, 8, 2))
    inner.op("multiclass_nms", {"BBoxes": [bx], "Scores": [sc]}, attrs={"keep_top_k": 8},
             shape_args=[bx, sc])
    inner.mark_output("c_in", bx, sc)
    b = GraphBuilder("outer")
    c = b.input("c", (1,), precision=Precision.BOOL)
    bx = b.input("b", (1, 8, 4))
    sc = b.input("s", (1, 8, 2))
    outs = b.op("while", {"X": [c, bx, sc]}, attrs={"block": inner.build()},
                shape_args=[c, bx, sc], out_slots=("Out",),
                out_precisions=[Precision.BOOL, Precision.FP32, Precision.FP32])
    b.mark_output(outs[1])
    with pytest.raises(ValueError, match="multiclass_nms"):
        compile_graph(b.build(), device=CPU)


def test_predictor_runs_a_while_graph():
    g = beam_decode.build(vocab=50, steps=5, **SMALL)
    feed = beam_decode.feed(**SMALL)
    got = Predictor(g, device="cpu").run(feed)
    _assert_equal(got, _eager(g, feed))


# ---- the decode loop against the reference ---------------------------------------------------

def test_decode_loop_matches_reference():
    """b2 / beam 2 / vocab 50 / 5 steps: the ids equal, the scores within
    rtol 1e-5 / atol 1e-6, five trips in both."""
    g = beam_decode.build(vocab=50, steps=5, **SMALL)
    feed = beam_decode.feed(**SMALL)
    got = _eager(g, feed)
    want = _run_reference(_reference(g), feed)
    ids, scores, steps = g.outputs
    np.testing.assert_array_equal(got[ids].numpy(), want[ids])
    np.testing.assert_allclose(got[scores].numpy(), want[scores], rtol=1e-5, atol=1e-6)
    assert got[steps].item() == want[steps].item() == 5.0


# ---- the control-flow artifact both ways -----------------------------------------------------

def test_port_artifact_runs_in_the_reference(tmp_path):
    g = beam_decode.build(vocab=50, steps=5, **SMALL)
    feed = beam_decode.feed(**SMALL)
    path = str(tmp_path / "decode.pnb")
    Predictor(g, device="cpu").save(path)
    rg = r_artifact.load(path)
    want = R.build_callable(rg, platform="cpu")(R.stage_weights(rg), feed)
    got = load_predictor(path, device="cpu").run(feed)
    ids, scores, _ = g.outputs
    np.testing.assert_array_equal(got[ids].numpy(), np.asarray(want[ids]))
    np.testing.assert_allclose(got[scores].numpy(), np.asarray(want[scores]),
                               rtol=1e-5, atol=1e-6)


def test_reference_artifact_runs_in_the_port(tmp_path):
    """The reference's own control-flow round-trip graph (``tests/
    test_artifact.py``), saved by the reference and run by the port."""
    from paddle_lite_tpu import GraphBuilder as RBuilder
    from paddle_lite_tpu.core.types import Precision as RPrecision

    bb = RBuilder("block")
    bb.input("cond_in", (1,), precision=RPrecision.BOOL)
    x_in = bb.input("x_in", (1,))
    bb.weight("one", np.ones((1,), np.float32))
    bb.weight("limit", np.full((1,), 3.0, np.float32))
    nx = bb.eltwise(x_in, "one", "add")
    nc = bb.op("less_than", {"X": [nx], "Y": ["limit"]}, shape_args=[nx, "limit"])[0]
    bb.mark_output(nc, nx)
    b = RBuilder("outer")
    cond0 = b.input("cond", (1,), precision=RPrecision.BOOL)
    x0 = b.input("x", (1,))
    outs = b.op("while", {"X": [cond0, x0]},
                attrs={"block": bb.build(), "cond_index": 0, "max_iters": 10},
                shape_args=[cond0, x0], out_slots=("Out",))
    b.mark_output(outs[1])
    rg = b.build()
    path = str(tmp_path / "cf.pnb")
    r_artifact.save(rg, path)
    feed = {"cond": np.ones((1,), np.bool_), "x": np.zeros((1,), np.float32)}
    want = R.build_callable(rg, platform="cpu")(R.stage_weights(rg), feed)
    pred = load_predictor(path, device="cpu")
    got = pred.run(feed)
    name = pred.output_names[0]
    assert got[name].item() == np.asarray(want[rg.outputs[0]]).item() == 3.0
    assert [ex.trips for ex in pred._fn.control_flow] == [3]
