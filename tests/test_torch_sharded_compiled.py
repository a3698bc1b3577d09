"""The compiled ``ShardedPredictor`` (``parallel/sharding.py`` over
``core/executor.CompiledGraph``) on the CPU, against the eager loop and the
JAX package's ``ShardedPredictor`` (``jax.jit``), whose ``tp_ops`` the
module fixture unregisters again when the file ends (the known
``test_arena`` flake, ``ROADMAP.md``).

MobileNetV1 at width 0.25, b4 / 32 px, 16 classes, optimized by the
reference and carried across, every intermediate among its outputs; its
meshes (data, model) = (2, 1) and (1, 2) in two spawned gloo ranks (one
spawn, with a deadline) and (1, 1) in this process.  Two graphs: the
reference's tags (``"torch"`` here, the reference's ``"xla"``) and the
same graph with them as ``"cuda"`` (the port's main-path tags; on CPU
tensors each wrapper runs its plain version).

- The compiled outputs, every intermediate, equal the eager loop's bit for
  bit on two feeds, and a later call leaves the first result unchanged.
- Against the reference's ``ShardedPredictor`` on the same graph and feed:
  every int8 intermediate bit for bit with the reference's tags, within
  the port's tie rule with ``"cuda"`` (``tests/test_torch_sharding.py``'s
  rule: the kernels requantize by ``y * fp32(1 / s)``), every fp32 value
  within that file's rtol / atol 1e-4; ``use_tp_cuda=False`` against
  ``use_tp_pallas=False`` the same way.
- The plan cuts only at collectives that run: 1 segment at 1x1 and 2x1,
  16 at 1x2 (15 split ops); the static input buffers hold the rank's
  data shard.
- The public warm-up and capture exist only on the compiled predictor;
  an img/s reading's request count fills its window.
"""

import copy
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.parallel import sharding as r_sharding
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1
from paddle_lite_tpu_torch.parallel import distributed, scaling_bench, sharding
from paddle_lite_tpu_torch.testing import parallel as tparallel

BATCH, SIZE, CLASSES = 4, 32, 16
MESHES_2 = ((2, 1), (1, 2))
MESHES = ((1, 1),) + MESHES_2
SEGMENTS = {(1, 1): 1, (2, 1): 1, (1, 2): 16}
TAGS = ("torch", "cuda")
SPAWN_TIMEOUT_S = 150
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_sharding.py's


@pytest.fixture(scope="module", autouse=True)
def reference_tp_ops_unregistered():
    """As ``tests/test_torch_sharding.py`` leaves it: the reference's op
    table without its ``"tp_pallas"`` impls, which its ``tp_ops`` registers
    when imported, and that module out of ``sys.modules``."""
    yield
    from paddle_lite_tpu.core.registry import OPS as R_OPS

    for n in R_OPS.names():
        R_OPS.get(n).impls.pop("tp_pallas", None)
    sys.modules.pop("paddle_lite_tpu.parallel.tp_ops", None)
    import paddle_lite_tpu.parallel as r_parallel

    r_parallel.__dict__.pop("tp_ops", None)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_graph():
    g = r_mnv1.build(batch=BATCH, image_size=SIZE, num_classes=CLASSES, width_mult=0.25,
                     seed=0)
    rng = np.random.default_rng(0)
    r_optimize(g, quant=R.QuantConfig(), calib_batches=[
        {"image": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)}])
    return g


@pytest.fixture(scope="module")
def feeds():
    return [{"image": np.random.default_rng(s).normal(size=(BATCH, SIZE, SIZE, 3))
             .astype(np.float32)} for s in (7, 8)]


def _port(ref_graph, tag):
    g = graph_from_reference(r_artifact.graph_to_meta(ref_graph), ref_graph.weights)
    return g if tag == "torch" else testing.retag(g, "torch", tag)


@pytest.fixture(scope="module")
def runs(ref_graph, feeds, tmp_path_factory):
    """By tag and mesh, rank 0's runs; every rank's outputs agree."""
    paths = []
    for tag in TAGS:
        path = tmp_path_factory.mktemp("compiled") / f"{tag}.pkl"
        with open(path, "wb") as f:
            pickle.dump(_port(ref_graph, tag), f)
        paths.append(str(path))
    ranks = distributed.spawn(tparallel.compiled_runs, 2, (paths, feeds, MESHES_2),
                              timeout_s=SPAWN_TIMEOUT_S, threads=1)
    for other in ranks[1:]:
        for by_a, by_b in zip(other, ranks[0]):
            for a, b in zip(by_a, by_b):
                for i in range(len(feeds)):
                    for k in a["compiled"][i]:
                        np.testing.assert_array_equal(a["compiled"][i][k],
                                                      b["compiled"][i][k])
    ones = tparallel.compiled_runs(paths, feeds, ((1, 1),))
    return {tag: {r["mesh"]: r for r in by_mesh + one}
            for tag, by_mesh, one in zip(TAGS, ranks[0], ones)}


@pytest.fixture(scope="module")
def ref_runs(ref_graph, feeds):
    """The reference's ShardedPredictor, every intermediate an output, by
    (mesh, use_tp_pallas), on the first feed."""
    out = {}
    for (dp, tp) in MESHES:
        for pallas in (True, False):
            g = copy.deepcopy(ref_graph)
            g.outputs = list(g.outputs) + [n for op in g.topological_order()
                                           for ns in op.outputs.values() for n in ns
                                           if n not in g.outputs]
            sp = r_sharding.ShardedPredictor(g, r_sharding.MeshConfig(data=dp, model=tp),
                                             devices=jax.devices()[:dp * tp],
                                             use_tp_pallas=pallas)
            out[(dp, tp), pallas] = {k: np.asarray(jax.device_get(v))
                                     for k, v in sp.run(feeds[0]).items()}
    return out


def _held(got: dict, want: dict, exact_int8: bool) -> None:
    assert set(want) <= set(got)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype == np.int8 and exact_int8:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= testing.TIE_LSB, name
            assert (d > 0).sum() <= max(testing.TIE_COUNT, testing.TIE_FRACTION * d.size), name
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("dp,tp", MESHES)
def test_compiled_is_the_eager_loop(runs, feeds, tag, dp, tp):
    run = runs[tag][(dp, tp)]
    for i in range(len(feeds)):
        got, want = run["compiled"][i], run["eager"][i]
        assert set(got) == set(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (i, k)
    out = next(iter(run["compiled"][0]))
    assert not np.array_equal(run["compiled"][0][out], run["compiled"][1][out])
    assert run["first_unchanged"] and run["first_unshared"]


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("dp,tp", MESHES)
def test_compiled_is_the_reference(runs, ref_runs, tag, dp, tp):
    run = runs[tag][(dp, tp)]
    _held(run["compiled"][0], ref_runs[(dp, tp), True], exact_int8=tag == "torch")
    assert run["n_tp_ops"] == (14 if tp == 2 else 0)
    assert run["n_split_ops"] == (15 if tp == 2 else 0)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("dp,tp", MESHES)
def test_use_tp_cuda_false_is_use_tp_pallas_false(runs, ref_runs, tag, dp, tp):
    """Nothing retagged to ``"tp_cuda"``, every ``"cuda"`` tag ``"torch"``:
    the reference's tags' run, bit for bit, whichever tags the graph had."""
    run = runs[tag][(dp, tp)]
    assert run["plain_tp_ops"] == 0 and run["plain_tags"] == ["torch"]
    _held(run["plain"], ref_runs[(dp, tp), False], exact_int8=True)
    for k, v in runs["torch"][(dp, tp)]["plain"].items():
        assert run["plain"][k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("dp,tp", MESHES)
def test_the_plan_cuts_only_at_collectives_that_run(runs, dp, tp):
    for tag in TAGS:
        run = runs[tag][(dp, tp)]
        assert run["n_segments"] == SEGMENTS[(dp, tp)]
        assert run["eager_segments"] == 0 and run["n_graphs"] == 0  # no CUDA graph here
        assert run["input_shapes"] == {"image": (BATCH // dp, SIZE, SIZE, 3)}


def test_capture_needs_the_eager_loop(ref_graph, feeds):
    g = _port(ref_graph, "cuda")
    seen = []
    with pytest.raises(ValueError, match="pass compiled=False"):
        sharding.ShardedPredictor(copy.deepcopy(g), sharding.MeshConfig(), ["cpu"],
                                  capture=lambda n, v: seen.append(n))
    sp = sharding.ShardedPredictor(g, sharding.MeshConfig(), ["cpu"], compiled=False,
                                   capture=lambda n, v: seen.append(n))
    sp.run(feeds[0])
    assert set(g.outputs) <= set(seen) and sp.n_segments == 0


def test_scaling_bench_rows_on_the_compiled_path(capsys):
    """The bench at n = 2, tp = 2 (a 1x2 mesh, two CPU ranks): the
    reference's row keys, after a warm-up request that compiles."""
    rows = scaling_bench.run_scaling(mobilenet_v1.build, per_device_batch=2, image_size=32,
                                     device_counts=(2,), tp=2, cpu_devices=2, loop=2)
    assert [(r["devices"], r["dp"], r["tp"], r["batch"]) for r in rows] == [(2, 1, 2, 2)]
    assert set(rows[0]) == {"devices", "dp", "tp", "batch", "images_per_sec", "efficiency"}
    assert rows[0]["images_per_sec"] > 0 and rows[0]["efficiency"] == 1.0


def test_warm_up_and_capture_belong_to_the_compiled_run(ref_graph, feeds):
    """The compiled predictor's warm-up, alone, leaves a run that equals the
    eager loop's; the eager predictor has nothing to warm up or capture."""
    g = _port(ref_graph, "cuda")
    eager = sharding.ShardedPredictor(copy.deepcopy(g), sharding.MeshConfig(), ["cpu"],
                                      compiled=False)
    for call in (lambda: eager.warm_up(feeds[0]), eager.capture,
                 lambda: eager.input_shapes):
        with pytest.raises(ValueError, match="compiled=False"):
            call()
    sp = sharding.ShardedPredictor(g, sharding.MeshConfig(), ["cpu"])
    sp.warm_up(feeds[0])
    got, want = sp.run(feeds[1]), eager.run(feeds[1])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sp.input_shapes == {"image": (BATCH, SIZE, SIZE, 3)}


@pytest.mark.parametrize("least,window_s,want,timed", [
    (2, 0.05, 6, (2, 6)), (3, 0.01, 3, (3,)), (4, 0.25, 28, (4, 28))])
def test_a_reading_fills_its_window(monkeypatch, least, window_s, want, timed):
    """``reading_requests`` sizes a reading from `least` timed requests: a
    request that takes 0.01 s on the clock gives 1.1 windows' worth of
    them, timed again to check that they fill the window, and never fewer
    than `least`."""
    import time

    clock = [0.0]

    def run_once():
        clock[0] += 0.01

    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    n = tparallel.reading_requests(run_once, torch.device("cpu"), least, window_s)
    assert n == want and n * 0.01 >= window_s
    assert clock[0] == pytest.approx(0.01 * sum(timed))


def test_a_reading_is_timed_again_until_it_fills_its_window(monkeypatch):
    """Requests that speed up after the first timing: the count grows
    until a timed run lasts the window."""
    import time

    clock, calls = [0.0], [0]

    def run_once():
        calls[0] += 1
        clock[0] += 0.01 if calls[0] <= 3 else 0.001

    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    n = tparallel.reading_requests(run_once, torch.device("cpu"), 3, 0.05)
    assert n in (55, 56) and calls[0] == 3 + 6 + n  # timed at 3, 6, then n
