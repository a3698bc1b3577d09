"""The loaded program's runner (``formats/aot.LoadedProgram``) on the CPU.

On the card a loaded program without control flow is one CUDA graph,
captured at its first call over static input buffers and replayed (the
reference's ``exported.call``, one XLA computation); chip_smoke's phase
15b holds that.  On the CPU the runner calls the module on the same static
buffers, so the contract checked here is the card's: fresh outputs a call,
a second feed's own result, inputs cast to the graph's precision, a wrong
shape or a missing input refused; MobileNetV1 and SSD bit-equal to
``Predictor``; the host constants' copies folded at load (a CUDA graph
cannot capture a copy from pageable host memory).  The beam-search decode
loop (``while_loop``) is not captured on the CPU, as no program is, and
equals its eager run; on the card it is captured as one graph, its loop
a WHILE node (``tests/test_torch_device_control_flow.py``,
``tests/test_torch_graph_conditionals.py``, phases 14d and 15b).
"""

import numpy as np
import pytest
import torch

import paddle_lite_tpu_torch as P
from paddle_lite_tpu_torch.core.executor import build_callable, stage_weights
from paddle_lite_tpu_torch.formats import aot
from paddle_lite_tpu_torch.models import beam_decode, mobilenet_v1, ssd
from paddle_lite_tpu_torch.runtime.predictor import create_predictor

SMALL_DECODE = dict(batch=2, beam=2, hidden=8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].numpy().tobytes() == b[k].numpy().tobytes() for k in a)


def _mnv1():
    rng = np.random.default_rng(3)
    g = mobilenet_v1.build(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
    feeds = [{"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)} for _ in range(3)]
    pred = create_predictor(g, quant=P.QuantConfig(), calib_batches=feeds[:1], device="cpu")
    return g, pred, feeds[1:]


def _ssd():
    rng = np.random.default_rng(2)
    g = ssd.build(batch=1, image_size=160, num_classes=3, seed=0)
    feeds = [{"image": rng.normal(size=(1, 160, 160, 3)).astype(np.float32)} for _ in range(3)]
    pred = create_predictor(g, quant=P.QuantConfig(), calib_batches=feeds[:1], device="cpu")
    return g, pred, feeds[1:]


@pytest.fixture(scope="module")
def mnv1():
    g, pred, feeds = _mnv1()
    return g, pred, feeds, aot.load_compiled(aot.export_compiled(g, device="cpu"))


@pytest.mark.parametrize("model", ["mobilenet_v1", "ssd"])
def test_loaded_program_is_the_predictor(mnv1, model):
    if model == "mobilenet_v1":
        g, pred, feeds, run = mnv1
    else:
        g, pred, feeds = _ssd()
        run = aot.load_compiled(aot.export_compiled(g, device="cpu"))
    assert run.control_flow == [] and not run.captured and run.n_graphs == 0
    # the per-channel scales traced from numpy, copied once at load, not a call
    assert run.n_folded >= 27
    assert "lift_fresh_copy" not in run.module.code
    for feed in feeds:
        assert _bits_equal(run(feed), pred.run(feed))


def test_outputs_are_fresh_and_follow_the_feed(mnv1):
    g, _, feeds, run = mnv1
    first = run(feeds[0])
    kept = {k: v.clone() for k, v in first.items()}
    second = run(feeds[1])
    assert _bits_equal(first, kept)
    out = g.outputs[0]
    assert not torch.equal(first[out], second[out])
    assert first[out].untyped_storage().data_ptr() != second[out].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
               for v in second.values() for t in run._inputs.values())
    assert _bits_equal(run(feeds[0]), kept)


def test_inputs_are_cast_to_the_graph_precision(mnv1):
    _, _, feeds, run = mnv1
    x = feeds[0]["image"]
    want = run(feeds[0])
    assert run.meta["inputs"]["image"] == {"shape": [2, 32, 32, 3], "dtype": "float32"}
    assert _bits_equal(run({"image": x.astype(np.float64)}), want)
    assert _bits_equal(run({"image": torch.from_numpy(x).double()}), want)


def test_a_wrong_feed_is_refused(mnv1):
    _, _, feeds, run = mnv1
    with pytest.raises(ValueError, match=r"loaded program: input 'image' has shape "
                                         r"\(1, 32, 32, 3\), compiled for \(2, 32, 32, 3\)"):
        run({"image": feeds[0]["image"][:1]})
    with pytest.raises(ValueError, match=r"loaded program: missing inputs \['image'\]"):
        run({"x": feeds[0]["image"]})


def test_the_decode_loop_is_not_captured():
    g = beam_decode.build(vocab=50, steps=5, **SMALL_DECODE)
    run = aot.load_compiled(aot.export_compiled(g, device="cpu"))
    assert run.control_flow == ["while_loop"] and not run.captured
    eager = build_callable(g, device=torch.device("cpu"))
    w = stage_weights(g, torch.device("cpu"))
    for seed in (1, 2):
        feed = beam_decode.feed(seed=seed, **SMALL_DECODE)
        assert _bits_equal(run(feed), eager(w, feed))
    assert run.n_graphs == 0
