"""Control flow inside the CUDA graph: ``while`` and ``conditional_block``
as conditional nodes (``core/conditional_nodes``, library
``csrc/graph_cond.cu``), in the compiled predictor and the loaded exported
program.

On the card a graph with control flow is captured as one CUDA graph: a
``while`` is a WHILE node, a ``conditional_block`` (a ``cond``) two IF
nodes, their blocks' ops inline in the bodies, and a request reads nothing
back.  The CPU has no CUDA, so these tests hold the rest:

- the plan: a graph with control flow and no host step is one segment;
- each case of ``testing/control_flow_graphs`` (a loop of no trip, one that
  stops early, one cut by ``max_iters``, crossed and carried state, a
  ``conditional_block`` both ways with and without a nested ``while``, the
  decode loop at b2 / beam 2 / vocab 50 / 5 steps) through ``Predictor``,
  a loaded program and the eager loop, bit for bit, and against the
  reference's ``compile_graph`` within rtol 1e-5 / atol 1e-6; the loop
  whose block holds an int8 ``fc`` on the GEMM kernel's plain version,
  bit for bit;
- ``trips`` is read from the loop's device counter;
- the node protocol: with the library stood in by a model of stream
  capture that records its calls, the handle is made on the graph being
  captured, the node is added after the condition is set and before its
  body is captured and becomes the capture's dependency; a ``cond`` is two
  IF nodes; a node made in a body is added to that body's graph; the
  bodies' memory pool is routed once around the outermost body; and a
  capture of each case, through the predictor and the loaded program,
  makes the nodes ``NODES`` names in one graph with no host read.
"""

import contextlib
import ctypes
import gc
import itertools

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu_torch import build_callable, compile_graph, stage_weights
from paddle_lite_tpu_torch.core import conditional_nodes as cn
from paddle_lite_tpu_torch.core import executor
from paddle_lite_tpu_torch.formats import aot
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.runtime.predictor import Predictor
from paddle_lite_tpu_torch.testing import control_flow_graphs as cfg

CPU = torch.device("cpu")
CASES = cfg.cases()
OUTER = 7000  # the stream the stub's outer capture runs on
KINDS = {cn.IF: "if", cn.WHILE: "while"}


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


# ---- the plan -----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_a_graph_with_control_flow_is_one_segment(name):
    g = CASES[name][0]
    fn, _ = compile_graph(g, device=CPU)
    assert fn.n_segments == 1 and len(fn._steps) == 1
    assert [ex.__class__.__name__ for ex in fn.control_flow] == [
        {"while": "_While", "conditional_block": "_ConditionalBlock"}[op.op_type]
        for op in g.topological_order() if op.op_type in executor.CONTROL_FLOW]


# ---- the cases, every path ------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_every_path_is_the_eager_loop(loaded, name):
    g, feeds, trips = CASES[name]
    pred = Predictor(g, device="cpu")
    eager = build_callable(g, device=CPU)
    w = stage_weights(g, CPU)
    reference = _reference(g)
    for feed, want_trips in zip(feeds, trips):
        got = pred.run(feed)
        assert _bits_equal(got, eager(w, feed))
        assert _bits_equal(got, loaded[name](feed))
        if want_trips is not None:
            assert [ex.trips for ex in pred._fn.control_flow] == [want_trips]
        want = reference(feed)
        for n in g.outputs:
            np.testing.assert_allclose(got[n].numpy(), want[n], rtol=1e-5, atol=1e-6)


def test_a_loop_around_the_int8_gemm():
    """The loop whose block holds an int8 ``fc`` tagged ``"cuda"`` (the
    GEMM kernel's plain version on the CPU): the predictor, a loaded
    program and the eager loop bit for bit, four trips.  The export makes
    the block's folded scale before the trace (a constant made inside the
    block that Dynamo traces would be a tensor of the block's graph, which
    ``torch.export.save`` refuses)."""
    g = cfg.int8_loop()
    feed = cfg.int8_feed()
    eager = build_callable(g, device=CPU)(stage_weights(g, CPU), feed)
    pred = Predictor(g, device="cpu")
    got = pred.run(feed)
    assert _bits_equal(got, eager)
    run = aot.load_compiled(aot.export_compiled(g, device="cpu"))
    assert _bits_equal(got, run(feed)) and run.control_flow == ["while_loop"]
    steps, x = g.outputs
    assert got[steps].item() == 4 and got[x].dtype == torch.int8
    assert [ex.trips for ex in pred._fn.control_flow] == [4]


def test_trips_is_read_from_the_device_counter():
    g, feeds, _ = CASES["gated_loop"]
    fn, w = compile_graph(g, device=CPU)
    (loop,) = fn.control_flow
    for feed, want in zip(feeds, (5, 0)):
        fn(w, feed)
        assert loop.counter.dtype == torch.int32 and loop.counter.item() == want
        assert loop.trips == want
    loop.counter.fill_(9)
    assert loop.trips == 9  # read from the counter, not kept on the host


# ---- the node protocol, against a model of stream capture --------------------------------

class _Runtime:
    """Stands in for the library on the CPU: a model of stream capture
    (the graph each stream captures into and the capture's dependencies)
    that records every call.  Graph, node, handle and stream ids are ints;
    graph 1 is the outer capture's, on stream OUTER."""

    def __init__(self):
        self.ids = itertools.count(10)
        self.calls = []
        self.into = {OUTER: 1}  # stream -> the graph it captures into
        self.deps = {OUTER: []}  # stream -> the capture's dependencies
        self.arrays = {}  # a dependency array's address -> its nodes
        self.handles = {}  # handle -> the graph it was made on
        self.bodies = {}  # body graph -> its node

    def _ret(self, ref, value):
        ref._obj.value = value

    def plt_graph_capture_info(self, stream, graph, deps, n):
        if stream not in self.into:
            return 100001
        addr = next(self.ids)
        self.arrays[addr] = list(self.deps[stream])
        self._ret(graph, self.into[stream])
        self._ret(deps, addr)
        self._ret(n, len(self.deps[stream]))
        self.calls.append(("capture_info", stream, self.into[stream]))
        return 0

    def plt_graph_cond_handle(self, graph, handle):
        h = next(self.ids)
        self.handles[h] = graph.value
        self._ret(handle, h)
        self.calls.append(("handle", graph.value, h))
        return 0

    def plt_graph_set_cond(self, stream, handle, flag):
        kernel = next(self.ids)
        self.calls.append(("set", stream, self.into[stream], handle, tuple(self.deps[stream]),
                           kernel))
        self.deps[stream] = [kernel]
        return 0

    def plt_graph_add_cond_node(self, graph, deps, n, handle, kind, node, body):
        nd, bg = next(self.ids), next(self.ids)
        self.bodies[bg] = nd
        self._ret(node, nd)
        self._ret(body, bg)
        self.calls.append(("node", graph.value, handle, KINDS[kind],
                           tuple(self.arrays[deps.value][:n.value]), nd, bg))
        return 0

    def plt_graph_set_deps(self, stream, node):
        self.deps[stream] = [node.value]
        self.calls.append(("deps", stream, node.value))
        return 0

    def plt_graph_begin_body(self, stream, body):
        assert stream not in self.into, "a stream that is already capturing"
        self.into[stream], self.deps[stream] = body.value, []
        self.calls.append(("begin_body", stream, body.value))
        return 0

    def plt_graph_end_body(self, stream, body):
        graph = self.into.pop(stream)
        self.calls.append(("end_body", stream, body.value))
        return 0 if graph == body.value else 100002

    def plt_graph_stream(self, out):
        self._ret(out, next(self.ids))
        return 0

    def plt_graph_error(self, code):
        return b"stub error"

    def nodes(self):
        """(kind, depth) of every node, in order; depth 0 is the outer
        graph's."""
        depth = {1: 0}
        out = []
        for c in self.calls:
            if c[0] == "node":
                depth[c[6]] = depth[c[1]] + 1
                out.append((c[3], depth[c[1]]))
        return out


class _SideStream:
    def __init__(self, raw: int):
        self.cuda_stream = raw


class _StubGraph:
    def replay(self):
        raise AssertionError("a stub graph is never replayed")


@pytest.fixture
def runtime(monkeypatch):
    """The library stood in by :class:`_Runtime`; a stub CUDA graph whose
    capture marks the current stream OUTER as capturing; the pool routing
    recorded; a host read of any tensor's truth raises while capturing."""
    rt = _Runtime()
    rt.capturing = False
    rt.pool_calls = []
    side = {}

    def side_stream(lib, device, depth):
        if depth not in side:
            raw = ctypes.c_void_p()
            lib.plt_graph_stream(ctypes.byref(raw))
            side[depth] = _SideStream(raw.value)
        return side[depth]

    class graph_ctx:
        def __init__(self, graph, capture_error_mode="global"):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            rt.capturing = True

        def __exit__(self, *exc):
            rt.capturing = False

    rt.current = [OUTER]  # torch's current stream, innermost last

    @contextlib.contextmanager
    def on_stream(stream):
        rt.current.append(stream.cuda_stream)
        try:
            yield
        finally:
            rt.current.pop()

    def pool_call(name):
        return lambda *a: rt.pool_calls.append((name, *a)) or ("pool", 1)

    real_bool = torch.Tensor.__bool__

    def no_host_read(t):
        if rt.capturing:
            raise AssertionError("a condition was read on the host during the capture")
        return real_bool(t)

    monkeypatch.setattr(cn, "capturing", lambda device: rt.capturing)
    monkeypatch.setattr(cn, "_library", lambda device: rt)
    monkeypatch.setattr(cn, "_current_stream", lambda device: rt.current[-1])
    monkeypatch.setattr(cn, "_side_stream", side_stream)
    monkeypatch.setattr(cn, "_on_stream", on_stream)
    monkeypatch.setattr(cn, "_torch_call", pool_call)
    monkeypatch.setattr(cn, "_release", lambda device, pool: rt.pool_calls.append(
        ("_cuda_releasePool", device, pool)))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph_ctx)
    monkeypatch.setattr(torch.Tensor, "__bool__", no_host_read)
    return rt


def _capture(rt, fn):
    """`fn()` captured by ``capture_cuda_graph`` on the stub."""
    return executor.capture_cuda_graph(fn)


def test_a_while_node_is_made_in_order(runtime):
    """The handle on the graph being captured, the condition set, the
    node after that kernel, the node the capture's dependency, then the
    body captured into the node's body graph on a side stream, ending with
    the kernel that sets the condition again."""
    flag = torch.ones((), dtype=torch.bool)
    ran = []
    graph, _ = _capture(runtime, lambda: cn.while_node(flag, lambda: ran.append(1)))
    assert ran == [1]  # the body is captured once
    calls = runtime.calls
    assert [c[0] for c in calls] == ["capture_info", "handle", "set", "capture_info", "node",
                                     "deps", "begin_body", "set", "end_body"]
    _, (_, g, h), set1, _, node, deps, begin, set2, end = calls
    assert g == 1 and runtime.handles[h] == 1  # made on the graph being captured
    assert set1[1:4] == (OUTER, 1, h)
    _, ng, nh, kind, ndeps, nd, body = node
    assert (ng, nh, kind, ndeps) == (1, h, "while", (set1[5],))  # after the set kernel
    assert deps == ("deps", OUTER, nd)  # the node becomes the dependency
    side = begin[1]
    assert side != OUTER and begin[2] == body  # the body is captured after the node
    assert set2[1:4] == (side, body, h)  # the body ends by setting the condition
    assert end == ("end_body", side, body)
    assert [c[0] for c in runtime.pool_calls] == [
        "_graph_pool_handle", "_cuda_beginAllocateCurrentThreadToPool",
        "_cuda_endAllocateToPool"]  # the pool's first reference kept for the graph
    del graph
    gc.collect()
    assert runtime.pool_calls[-1][0] == "_cuda_releasePool"  # released with the graph


def test_a_cond_is_two_if_nodes_nesting_a_loop(runtime):
    """``conditional_block`` holding a ``while`` through the compiled
    predictor's capture: an IF node on the flag, the WHILE node inside its
    body (its handle made on that body's graph, its body on a deeper side
    stream), then the IF node on the negation after the first; the pool
    routed once around each outermost body."""
    g, feeds, _ = CASES["cond_while"]
    fn, w = compile_graph(g, device=CPU)
    fn.warm_up(w, feeds[0])
    fn.capture()
    assert fn.n_graphs == 1
    nodes = [c for c in runtime.calls if c[0] == "node"]
    assert [(c[3], c[1]) for c in nodes] == [("if", 1), ("while", nodes[0][6]), ("if", 1)]
    first_if, loop, second_if = nodes
    assert runtime.handles[loop[2]] == first_if[6]  # the handle on the body's graph
    # the second IF node follows the first: its set kernel depends on it
    set2 = [c for c in runtime.calls if c[0] == "set" and c[3] == second_if[2]][0]
    assert set2[4] == (first_if[5],) and second_if[4] == (set2[5],)
    begins = [c for c in runtime.calls if c[0] == "begin_body"]
    assert len({b[1] for b in begins[:2]}) == 2  # the nested body on its own stream
    routes = [c[0] for c in runtime.pool_calls if c[0] != "_graph_pool_handle"]
    assert routes == ["_cuda_beginAllocateCurrentThreadToPool", "_cuda_endAllocateToPool",
                      "_cuda_beginAllocateCurrentThreadToPool", "_cuda_endAllocateToPool",
                      "_cuda_releasePool"]  # the second routing's reference returned


@pytest.mark.parametrize("name", list(CASES))
def test_a_capture_makes_the_cases_nodes(runtime, loaded, name):
    """The compiled predictor's capture and the loaded program's each make
    one CUDA graph holding the nodes ``NODES`` names, and read no
    condition on the host."""
    g, feeds, _ = CASES[name]
    fn, w = compile_graph(g, device=CPU)
    fn.warm_up(w, feeds[0])
    fn.capture()
    assert fn.n_graphs == 1 and runtime.nodes() == cfg.NODES[name]
    runtime.calls.clear()
    run = loaded[name]
    aot.load_static_inputs("loaded program", feeds[0], run._inputs, None)
    with torch.no_grad():
        run._record()
    assert run.n_graphs == cfg.LOADED_GRAPHS[name] == 1
    assert runtime.nodes() == cfg.NODES[name]
    run._graph = None  # the stub graph is never replayed


def test_a_failed_body_capture_raises_and_ends_the_body(runtime):
    """A body that fails still ends its capture, and the error is the
    body's; a failed runtime call raises naming it."""
    flag = torch.ones((), dtype=torch.bool)

    def body():
        raise RuntimeError("the body failed")

    with pytest.raises(RuntimeError, match="the body failed"):
        _capture(runtime, lambda: cn.while_node(flag, body))
    assert runtime.calls[-1][0] == "end_body"
    runtime.plt_graph_add_cond_node = lambda *a: 900
    with pytest.raises(RuntimeError, match=r"cudaGraphAddNode failed: stub error \(900\)"):
        _capture(runtime, lambda: cn.if_node(flag, lambda: None))


def test_a_condition_is_a_one_element_bool(runtime):
    with pytest.raises(ValueError, match="one-element bool"):
        _capture(runtime, lambda: cn.while_node(torch.ones(2, dtype=torch.bool), lambda: None))
