"""A loaded exported program with control flow, captured as one CUDA graph.

On the card ``formats/aot.LoadedProgram`` captures a program that holds
``while_loop`` or ``cond`` as one CUDA graph, as ``compile_graph``
captures a graph with ``while`` / ``conditional_block``: a ``while_loop``
is a WHILE node and a ``cond`` two IF nodes (``core/conditional_nodes``),
the blocks' ops inline in the bodies, the conditions evaluated on the card
(``aot._ControlFlow``).  ``chip_smoke.py`` phase 14d holds every case here
captured on the card, 15b the decode loop at full size.  On the CPU the
same steps run without graphs, the conditions read on the host, so this
file holds their logic:

- each case of ``testing/control_flow_graphs`` (a loop of no trip, one that
  stops early, one cut by ``max_iters``, crossed and carried state, a
  ``conditional_block`` both ways with and without a nested ``while``, the
  decode loop at b2 / beam 2 / vocab 50 / 5 steps): the loaded program
  bit-equal to ``Predictor`` and to the eager loop on every feed, one
  program for all the feeds, and to the reference's ``compile_graph``
  (``jax.jit``) within the decode test's rtol 1e-5 / atol 1e-6;
- the capture: with the CUDA graph's capture stood in by a stub, each case
  captures the one graph ``LOADED_GRAPHS`` names, makes a conditional node
  at each higher-order op (the kinds ``NODES`` names) and reads no
  condition on the host;
- a carried input passed through (the decode loop's vocabulary
  projection) is given back as itself, and a block's host constants are
  read as constants of its own (folded at load).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu_torch import build_callable, stage_weights
from paddle_lite_tpu_torch.core import conditional_nodes as cn
from paddle_lite_tpu_torch.formats import aot
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.runtime.predictor import Predictor
from paddle_lite_tpu_torch.testing import control_flow_graphs as cfg

CPU = torch.device("cpu")
CASES = cfg.cases()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loaded():
    """name -> the case's loaded program, exported once."""
    return {name: aot.load_compiled(aot.export_compiled(g, device="cpu"))
            for name, (g, _, _) in CASES.items()}


def _bits_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].numpy().tobytes() == b[k].numpy().tobytes() for k in a)


def _reference(g):
    rg = r_artifact.graph_from_meta(p_artifact.graph_to_meta(g))
    rg.weights = dict(g.weights)
    rg.rebuild_links()
    fn, w = R.compile_graph(rg, platform="cpu")
    return lambda feed: {n: np.asarray(jax.device_get(v)) for n, v in fn(w, feed).items()}


@pytest.mark.parametrize("name", list(CASES))
def test_loaded_program_is_the_predictor(loaded, name):
    g, feeds, trips = CASES[name]
    run = loaded[name]
    assert not run.captured and run.n_graphs == 0  # no CUDA graph on the CPU
    pred = Predictor(g, device="cpu")
    eager = build_callable(g, device=CPU)
    w = stage_weights(g, CPU)
    reference = _reference(g)
    for feed, want_trips in zip(feeds, trips):
        got = run(feed)
        assert _bits_equal(got, pred.run(feed))
        assert _bits_equal(got, eager(w, feed))
        if want_trips is not None:
            assert [ex.trips for ex in pred._fn.control_flow] == [want_trips]
        want = reference(feed)
        for n in g.outputs:
            np.testing.assert_allclose(got[n].numpy(), want[n], rtol=1e-5, atol=1e-6)


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: replays nothing."""

    def replay(self):
        raise AssertionError("a stub graph is never replayed")


@pytest.mark.parametrize("name", list(CASES))
def test_the_capture_cuts_at_each_higher_order_op(loaded, name, monkeypatch):
    """The capture (a stub's on the CPU: the ops run as it records) is one
    graph: each ``while_loop`` / ``cond`` makes its conditional nodes
    inside it (a node's body run once, as it is captured), and no host
    step reads a condition between graphs."""
    capturing = []
    made = []

    class graph_ctx:
        def __init__(self, graph, capture_error_mode="global"):
            pass

        def __enter__(self):
            capturing.append(True)

        def __exit__(self, *exc):
            capturing.pop()

    def node(kind, flag, body, bodies):
        made.append({cn.IF: "if", cn.WHILE: "while"}[kind])
        body()

    real_bool = torch.Tensor.__bool__

    def no_host_read(t):
        assert not capturing, "a condition was read on the host during the capture"
        return real_bool(t)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph_ctx)
    monkeypatch.setattr(cn, "capturing", lambda device: bool(capturing))
    monkeypatch.setattr(cn, "_node", node)
    monkeypatch.setattr(torch.Tensor, "__bool__", no_host_read)
    run = loaded[name]
    g, feeds, _ = CASES[name]
    aot.load_static_inputs("loaded program", feeds[0], run._inputs, None)
    with torch.no_grad():
        run._record()
    assert run.n_graphs == cfg.LOADED_GRAPHS[name] == 1
    assert made == [kind for kind, _ in cfg.NODES[name]]
    assert set(run._out) == set(g.outputs)
    run._graph = None  # the stub graph is never replayed


def test_a_carried_input_is_passed_through(loaded):
    """The decode loop's vocabulary projection, carried unchanged, is the
    body's input given back (no copy in, out or back); the other state is
    the body's fresh output."""
    run = loaded["decode"]
    assert run.n_passed_through == 1
    body = run.module.while_loop_body_graph_0
    inputs = [n for n in body.graph.nodes if n.op == "placeholder"]
    out = list(next(n for n in body.graph.nodes if n.op == "output").args[0])
    assert getattr(body, aot.PASSED_THROUGH) == {len(out) - 1}
    assert out[-1] is inputs[len(out) - 1]
    assert all(o.op == "call_function" for o in out[:-1])


def test_a_blocks_host_constants_are_its_own(loaded):
    """A host constant that a ``cond`` branch reads on every run (the
    nested loop's limit) is a constant of the branch, folded at load, and
    no longer read from the branch's operand."""
    branch = loaded["cond_while"].module.true_graph_0
    inputs = [n for n in branch.graph.nodes if n.op == "placeholder"]
    assert not inputs[1].users
    assert any(n.startswith("_plt_host_") for n, _ in branch.named_buffers())
