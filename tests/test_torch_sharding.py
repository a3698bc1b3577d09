"""``parallel/sharding.py`` and ``parallel/tp_ops.py`` against the JAX
package's ``parallel/{sharding,tp_ops}.py``.

- The specs: ``weight_pspec`` / ``input_pspec`` equal the reference's, as
  tuples, for every var of ``test_sharding.py``'s ``_model`` and of
  MobileNetV1 (32 px, 16 classes) at each mesh shape.
- ``ShardedPredictor`` at (data, model) = (4, 1), (2, 2), (1, 4) in four
  spawned gloo ranks and (2, 1), (1, 2) in two (one spawn each), on the
  reference-optimized ``_model`` (batch 8, 8x8x16) carried across, against
  the reference's ``ShardedPredictor`` on the same graph and feed: the
  fp32 output within rtol / atol 1e-4 (``test_sharding.py:46``'s bound:
  the fp32 stem and fc sum in another order in XLA), every int8
  intermediate within the port's tie rule against the reference's
  single-device run (at most 1 LSB in at most ``testing.TIE_FRACTION``
  of elements: the kernels requantize by ``y * fp32(1 / s)``, the
  reference's XLA ops by ``y / s``).
- ``assign_tp_kernels`` retags the reference's op types and count, but
  for a padded 1x1 conv, which the port leaves (the reference's gate does
  not check paddings); its ``"tp_cuda"`` impls raise where the
  reference's fall back.

The reference's ``tp_ops`` registers ``"tp_pallas"`` impls in its op table
when imported (the known ``test_arena`` flake, ``ROADMAP.md`` §3); the
module fixture below takes them out again when the module ends, whichever
file of the worker imported it.
"""

import copy
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_lite_tpu as R
from paddle_lite_tpu import GraphBuilder
from paddle_lite_tpu.core.executor import build_callable as r_build_callable
from paddle_lite_tpu.core.executor import stage_weights as r_stage_weights
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.parallel import sharding as r_sharding
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.executor import ExecutionContext
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.parallel import distributed, sharding, tp_ops
from paddle_lite_tpu_torch.testing import parallel as tparallel

BATCH = 8
MESHES_4 = ((4, 1), (2, 2), (1, 4))
MESHES_2 = ((2, 1), (1, 2))
SPEC_MESHES = ((8, 1), (4, 2), (2, 4), (1, 8), (1, 1))
SPAWN_TIMEOUT_S = 150
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def reference_tp_ops_unregistered():
    """Leave the reference's op table as if its ``tp_ops`` had never been
    imported: no ``"tp_pallas"`` impl, and the module out of
    ``sys.modules``, so a later import registers again."""
    yield
    from paddle_lite_tpu.core.registry import OPS as R_OPS

    for n in R_OPS.names():
        R_OPS.get(n).impls.pop("tp_pallas", None)
    sys.modules.pop("paddle_lite_tpu.parallel.tp_ops", None)
    import paddle_lite_tpu.parallel as r_parallel

    r_parallel.__dict__.pop("tp_ops", None)


def _model(batch, padded_1x1=False):
    """test_sharding.py's ``_model`` (a padded 1x1 conv as an option)."""
    b = GraphBuilder("m", seed=31)
    x = b.input("x", (batch, 8, 8, 16))
    y = b.conv_bn_act(x, 32, 1, act="relu")
    y = b.conv_bn_act(y, 32, 3, padding=1, depthwise=True, act="relu")
    y = b.conv_bn_act(y, 64, 1, padding=1 if padded_1x1 else 0, act="relu")
    y = b.pool2d(y, "avg", global_pooling=True)
    y = b.reshape(y, (batch, 64))
    y = b.fc(y, 16)
    b.mark_output(y)
    return b.build()


def _optimized(graph, shape):
    rng = np.random.default_rng(0)
    r_optimize(graph, quant=R.QuantConfig(),
               calib_batches=[{graph.inputs[0]: rng.normal(size=shape).astype(np.float32)}])
    return graph


def _port(ref_graph):
    return graph_from_reference(r_artifact.graph_to_meta(ref_graph), ref_graph.weights)


def _jmesh(dp, tp):
    return Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp), ("data", "model"))


@pytest.fixture(scope="module")
def ref_model():
    return _optimized(_model(BATCH), (BATCH, 8, 8, 16))


@pytest.fixture(scope="module")
def feed():
    return {"x": np.random.default_rng(7).normal(size=(BATCH, 8, 8, 16)).astype(np.float32)}


# ---- the specs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_mnv1():
    return _optimized(r_mnv1.build(batch=8, image_size=32, num_classes=16, seed=0),
                      (8, 32, 32, 3))


@pytest.mark.parametrize("which", ["model", "mobilenet_v1"])
@pytest.mark.parametrize("dp,tp", SPEC_MESHES)
def test_specs_are_the_reference(ref_model, ref_mnv1, which, dp, tp):
    gr = ref_model if which == "model" else ref_mnv1
    g = _port(gr)
    jm, shape = _jmesh(dp, tp), {"data": dp, "model": tp}
    assert set(g.vars) == set(gr.vars)
    for name in gr.vars:
        assert sharding.weight_pspec(g, name, shape) == \
            tuple(r_sharding.weight_pspec(gr, name, jm)), name
        assert sharding.input_pspec(g, name, shape) == \
            tuple(r_sharding.input_pspec(gr, name, jm)), name


def test_specs_split_what_the_rule_splits(ref_mnv1):
    """At 1x2 the stem's fp32 filter, the 13 pointwise filters and the fc
    weight split on O; the depthwise filters stay whole, their biases are
    marked "model" but are read whole by the replicated depthwise op."""
    g = _port(ref_mnv1)
    shape = {"data": 1, "model": 2}
    split = sharding.split_ops(g, shape)
    types = sorted(op.op_type for op in g.ops if op.id in split)
    assert types == ["conv2d"] * 14 + ["fc"]
    weights = sharding.split_weights(g, shape)
    for op in g.ops:
        if op.op_type == "depthwise_conv2d":
            assert op.input("Filter") not in weights
            assert op.maybe_input("Bias") not in weights
            assert sharding.weight_pspec(g, op.input("Bias"), shape) == ("model",)


def test_batch_vars_are_the_activations(ref_mnv1):
    """Under a data split the vars computed from the input whose leading dim
    is the batch hold rows: every activation of MobileNetV1, no weight, and
    not an fc weight whose leading dim happens to equal the batch."""
    g = _port(ref_mnv1)
    rows = sharding.batch_vars(g)
    acts = {n for op in g.ops for n in op.output_names()} | set(g.inputs)
    assert rows == {n for n in acts if g.vars[n].shape[0] == 8}
    assert set(g.outputs) <= rows and not rows & set(g.weights)
    b = GraphBuilder("fc", seed=3)
    b.mark_output(b.fc(b.input("x", (4, 4)), 4))
    g = _port(b.build())
    w = g.ops[0].input("W")
    assert g.vars[w].shape[0] == 4 and w not in sharding.batch_vars(g)
    assert sharding.batch_vars(g) == {"x", g.outputs[0]}


# ---- the mesh -----------------------------------------------------------------

def test_mesh_config_validation():
    with pytest.raises(ValueError, match="needs"):
        sharding.MeshConfig(data=64, model=4).build()
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        sharding.MeshConfig(data=2).build(["cpu", "cpu"])
    m = sharding.MeshConfig().build(["cpu"])
    assert m.shape == {"data": 1, "model": 1} and m.device == torch.device("cpu")


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="cuda:0 is listed for ranks 0 and 1"):
        sharding.MeshConfig(model=2).build(["cuda:0", "cuda:0"], backend="nccl")
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        sharding.MeshConfig(model=2).build(["cpu", "cpu"], backend="nccl")


# ---- ShardedPredictor against the reference's ---------------------------------------

@pytest.fixture(scope="module")
def graph_file(ref_model, tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "graph.pkl"
    with open(path, "wb") as f:
        pickle.dump(_port(ref_model), f)
    return str(path)


@pytest.fixture(scope="module")
def port_runs(graph_file, feed):
    """Every mesh's run on rank 0, by mesh; every rank's outputs agree."""
    runs = {}
    for world, meshes in ((4, MESHES_4), (2, MESHES_2)):
        ranks = distributed.spawn(tparallel.sharded_runs, world, (graph_file, feed, meshes),
                                  timeout_s=SPAWN_TIMEOUT_S, threads=1)
        for r in ranks[1:]:
            for a, b in zip(r, ranks[0]):
                for k in a["out"]:
                    np.testing.assert_array_equal(a["out"][k], b["out"][k])
        runs.update({run["mesh"]: run for run in ranks[0]})
    return runs


@pytest.fixture(scope="module")
def ref_intermediates(ref_model, feed):
    g = copy.deepcopy(ref_model)
    seen = {}
    fn = r_build_callable(g, capture=lambda n, v: seen.__setitem__(n, np.asarray(v)))
    fn(r_stage_weights(g), feed)
    return seen


@pytest.mark.parametrize("dp,tp", MESHES_4 + MESHES_2)
def test_sharded_predictor_matches_the_reference(ref_model, feed, port_runs, ref_intermediates,
                                                 dp, tp):
    g = copy.deepcopy(ref_model)
    sp = r_sharding.ShardedPredictor(g, r_sharding.MeshConfig(data=dp, model=tp),
                                     devices=jax.devices()[:dp * tp])
    ref = np.asarray(jax.device_get(sp.run(feed)[g.outputs[0]]))
    run = port_runs[(dp, tp)]
    got = run["out"][g.outputs[0]]
    assert got.shape == ref.shape == (BATCH, 16)
    np.testing.assert_allclose(got, ref, **TOL)
    assert run["n_tp_ops"] == sp.n_tp_ops
    assert run["tagged"] == sorted(op.op_type for op in g.ops
                                   if op.attrs.get("kernel") == "tp_pallas")
    assert run["int8"], "no int8 intermediate captured"
    for name, v in run["int8"].items():
        want = ref_intermediates[name]
        assert v.shape == want.shape, name
        d = np.abs(v.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= testing.TIE_LSB, name
        assert (d > 0).sum() <= max(testing.TIE_COUNT, testing.TIE_FRACTION * d.size), name


def test_sharded_predictor_on_one_process(ref_model, feed, ref_intermediates):
    """A 1x1 mesh needs no process group: the eager loop, whole."""
    g = _port(ref_model)
    sp = sharding.ShardedPredictor(g, sharding.MeshConfig(), ["cpu"])
    assert sp.n_tp_ops == 0 and sp.n_split_ops == 0
    out = sp.run(feed)[g.outputs[0]].numpy()
    np.testing.assert_allclose(out, ref_intermediates[g.outputs[0]], **TOL)
    with pytest.raises(ValueError, match="has shape"):
        sp.run({"x": feed["x"][:2]})


# ---- assign_tp_kernels and the tp_cuda impls --------------------------------------

@pytest.mark.parametrize("which", ["model", "mobilenet_v1"])
@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2), (1, 8)])
def test_assign_tp_kernels_retags_the_reference_ops(ref_model, ref_mnv1, which, dp, tp):
    """The same op types and count; on MobileNetV1 (no padded 1x1 conv)
    the 13 pointwise convs and the fc."""
    from paddle_lite_tpu.parallel.tp_ops import assign_tp_kernels as r_assign

    src = ref_model if which == "model" else ref_mnv1
    gr = copy.deepcopy(src)
    g = _port(src)
    n_ref = r_assign(gr, _jmesh(dp, tp))
    n = tp_ops.assign_tp_kernels(g, {"data": dp, "model": tp})
    assert n == n_ref == (3 if which == "model" else 14)
    ours = sorted(op.op_type for op in g.ops if op.attrs.get("kernel") == "tp_cuda")
    assert ours == sorted(op.op_type for op in gr.ops if op.attrs.get("kernel") == "tp_pallas")
    assert "fc" in ours and "conv2d" in ours
    assert tp_ops.assign_tp_kernels(_port(src), {"data": 8, "model": 1}) == 0


def test_a_padded_1x1_conv_is_not_retagged():
    """The reference's gate takes a padded 1x1 conv (``tp_ops.py:128-134``);
    the port's does not (its GEMM over the unpadded rows is the wrong
    product)."""
    from paddle_lite_tpu.parallel.tp_ops import assign_tp_kernels as r_assign

    gr = _optimized(_model(BATCH, padded_1x1=True), (BATCH, 8, 8, 16))
    g = _port(gr)
    n_ref = r_assign(copy.deepcopy(gr), _jmesh(2, 2))
    n = tp_ops.assign_tp_kernels(g, {"data": 2, "model": 2})
    padded = [op for op in g.ops if op.op_type == "conv2d"
              and list(op.attrs.get("paddings", [0, 0])) != [0, 0]
              and g.vars[op.input("Filter")].shape[:2] == (1, 1)]
    assert len(padded) == 1 and padded[0].attrs.get("kernel") != "tp_cuda"
    assert n == n_ref - 1


def _one_op(op_type, ins_shapes, attrs, dtype=np.int8):
    b = GraphBuilder("one", seed=3)
    if op_type == "fc":
        x = b.input("x", ins_shapes[0])
        y = b.fc(x, ins_shapes[1][1])
    else:
        x = b.input("x", ins_shapes[0])
        y = b.conv2d(x, ins_shapes[1][3], 1, **attrs)
    b.mark_output(y)
    g = _port(b.build())
    return g, g.ops[0]


def _tp_context(g, mesh):
    """A sharded run's context on `mesh`; with no mesh, the plain context
    that a ``"tp_cuda"`` impl meets outside ``ShardedPredictor``."""
    if mesh is None:
        return ExecutionContext(graph=g, device=torch.device("cpu"))
    return sharding.ShardedContext(graph=g, device=torch.device("cpu"), mesh=mesh)


@pytest.mark.parametrize("case", ["no_mesh", "fp32", "residual", "padded"])
def test_tp_cuda_impls_raise_instead_of_falling_back(case):
    mesh = sharding.Mesh({"data": 1, "model": 2}, 0, torch.device("cpu"), "gloo",
                         {"data": None, "model": None})
    x8 = torch.ones((2, 4, 4, 8), dtype=torch.int8)
    w8 = torch.ones((1, 1, 8, 4), dtype=torch.int8)
    g, op = _one_op("conv2d", [(2, 4, 4, 8), (1, 1, 8, 4)],
                    {"padding": 1} if case == "padded" else {})
    ctx = _tp_context(g, None if case == "no_mesh" else mesh)
    ins = {"Input": [x8.float() if case == "fp32" else x8], "Filter": [w8]}
    if case == "residual":
        ins["ResidualData"] = [torch.zeros((2, 4, 4, 4))]
    with pytest.raises(ValueError, match=r"conv2d \(kernel='tp_cuda'\)"):
        tp_ops.conv1x1_tp_cuda(ctx, op, ins)
    g, op = _one_op("fc", [(2, 8), (8, 4)], {})
    ctx = _tp_context(g, None if case == "no_mesh" else mesh)
    if case in ("no_mesh", "fp32"):
        with pytest.raises(ValueError, match=r"fc \(kernel='tp_cuda'\)"):
            tp_ops.fc_tp_cuda(ctx, op, {"Input": [torch.ones((2, 8)) if case == "fp32" else
                                                  torch.ones((2, 8), dtype=torch.int8)],
                                        "W": [torch.ones((8, 4), dtype=torch.int8)]})
