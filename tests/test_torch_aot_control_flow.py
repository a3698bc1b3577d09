"""Control flow through the AOT export (``formats/aot``), on the CPU.

``while`` exports as ``torch._higher_order_ops.while_loop`` and
``conditional_block`` as ``torch.cond`` (the reference's ``jax.export``
carries ``lax.while_loop`` / ``lax.cond``).  Each graph is exported,
serialized, loaded back and run; its outputs equal ``Predictor``'s bit for
bit: the beam-search decode loop (``models/beam_decode``), a
``conditional_block`` with the flag set and clear, one holding a ``while``
loop, and a loop cut short by ``max_iters``.  The decode loop's export is
also held to the reference's own exported program (ids equal, scores
within rtol 1e-5 / atol 1e-6, the decode test's bound).
"""

import jax
import numpy as np
import pytest
import torch

from paddle_lite_tpu.formats import aot as r_aot
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu_torch.formats import aot
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.models import beam_decode
from paddle_lite_tpu_torch.runtime.predictor import Predictor
from paddle_lite_tpu_torch.testing import control_flow_graphs as cf_graphs

SMALL = dict(batch=2, beam=2, hidden=8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round_trip(g, tmp_path):
    path = str(tmp_path / "program.pt2")
    aot.save_compiled(g, path, device="cpu")
    return aot.load_compiled_file(path)


def _bits_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k


def _hops(run) -> set:
    """The higher-order ops of the program, its blocks' graphs included."""
    return {n.target.name() for m in run.program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
            if isinstance(n.target, torch._ops.HigherOrderOperator)}


def test_decode_loop_exports(tmp_path):
    g = beam_decode.build(vocab=50, steps=5, **SMALL)
    run = _round_trip(g, tmp_path)
    assert _hops(run) == {"while_loop"}
    pred = Predictor(g, device="cpu")
    for seed in (1, 2):
        feed = beam_decode.feed(seed=seed, **SMALL)
        _bits_equal(run(feed), pred.run(feed))
    assert run(feed)[g.outputs[2]].item() == 5.0


def test_decode_loop_export_is_the_references(tmp_path):
    g = beam_decode.build(vocab=50, steps=5, **SMALL)
    feed = beam_decode.feed(**SMALL)
    rg = r_artifact.graph_from_meta(p_artifact.graph_to_meta(g))
    rg.weights = dict(g.weights)
    rg.rebuild_links()
    path = str(tmp_path / "decode.stablehlo")
    r_aot.save_compiled(rg, path)
    want = {k: np.asarray(jax.device_get(v))
            for k, v in r_aot.load_compiled_file(path)(feed).items()}
    got = _round_trip(g, tmp_path)(feed)
    ids, scores, steps = g.outputs
    np.testing.assert_array_equal(got[ids].numpy(), want[ids])
    np.testing.assert_allclose(got[scores].numpy(), want[scores], rtol=1e-5, atol=1e-6)
    assert got[steps].item() == want[steps].item() == 5.0


@pytest.mark.parametrize("nested_while", [False, True])
def test_conditional_block_exports(tmp_path, nested_while):
    g = cf_graphs.cond_graph(nested_while=nested_while)
    run = _round_trip(g, tmp_path)
    assert _hops(run) == ({"cond", "while_loop"} if nested_while else {"cond"})
    pred = Predictor(g, device="cpu")
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    outs = {}
    for flag in (True, False):
        feed = {"x": x, "flag": np.array([flag])}
        outs[flag] = run(feed)
        _bits_equal(outs[flag], pred.run(feed))
    assert not torch.equal(outs[True][g.outputs[0]], outs[False][g.outputs[0]])


_counting_loop = cf_graphs.counting_loop


@pytest.mark.parametrize("limit,max_iters,trips", [(5.0, 100, 5), (5.0, 3, 3), (1.0, 4, 1)])
def test_max_iters_bounds_the_exported_loop(tmp_path, limit, max_iters, trips):
    g = _counting_loop(limit, max_iters)
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    got = _round_trip(g, tmp_path)(feed)
    pred = Predictor(g, device="cpu")
    _bits_equal(got, pred.run(feed))
    assert got[g.outputs[0]].item() == trips
    assert [ex.trips for ex in pred._fn.control_flow] == [trips]
