"""The ``nbf`` artifact (the ``.nb`` analog) through both packages: one file
format, written and read by either.

- Port save → port load gives the same graph (the same meta JSON, weights
  bit for bit) and, through ``Predictor.save`` / ``load_predictor``, the
  same outputs bit for bit, with no pass run on load.
- The reference's save → the port's load → the port's run equals the
  reference's run: every int8 tensor within the 1-LSB tie rule
  (``paddle_lite_tpu_torch.testing``), the softmax within 1e-3
  (``testing.SOFTMAX_ATOL``); and the port's save → the reference's load →
  its run equals the port's run the same way.
- Weight-only W16 / W8 and packed W4 (``pack_axis``) graphs both ways.
- The port's file is byte-identical to the reference's for the same
  optimized graph; a ``"cuda"`` tag is written as ``"pallas"`` and the
  reference loads it with the same kernels picked.
- A corrupt blob, a bad magic and a truncated file each raise ``IOError``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core import pass_manager
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1 as p_mnv1
from paddle_lite_tpu_torch.runtime.predictor import (Predictor, create_predictor,
                                                     load_predictor)
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
KW = dict(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
SHAPE = (2, 32, 32, 3)


def _feed(seed):
    return {"image": np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)}


def _port_graph(**quant):
    g = p_mnv1.build(**KW)
    if quant.get("weight_only"):
        optimize(g, quant=P.QuantConfig(**quant), device="cpu")
    else:
        optimize(g, quant=P.QuantConfig(**quant), calib_batches=[_feed(1)], device="cpu")
    return g


def _ref_graph(**quant):
    g = r_mnv1.build(**KW)
    if quant.get("weight_only"):
        r_optimize(g, quant=R.QuantConfig(**quant))
    else:
        r_optimize(g, quant=R.QuantConfig(**quant), calib_batches=[_feed(1)])
    return g


def _meta_json(meta):
    return json.dumps(meta, sort_keys=False)


def _same_weights(a, b):
    assert sorted(a) == sorted(b)  # a file holds its blobs in name order
    for n in a:
        x, y = np.asarray(a[n]), np.asarray(b[n])
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), n


def _ref_capture(g, feed):
    env = {}
    R.build_callable(g, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))(
        R.stage_weights(g), feed)
    return {k: np.asarray(jax.device_get(v)) for k, v in env.items()}


def _port_capture(g, feed):
    return {k: v.numpy() for k, v in
            testing.capture_all(g, P.stage_weights(g, CPU), feed, CPU).items()}


def assert_runs_agree(ref_env, port_env, out):
    """int8 tensors within the tie rule, float outputs within
    SOFTMAX_ATOL, every captured tensor of the same shape and dtype."""
    assert set(ref_env) == set(port_env)
    diffs = []
    for n, r in ref_env.items():
        g = port_env[n]
        assert g.shape == r.shape and g.dtype == r.dtype, n
        if r.dtype == np.int8:
            diffs.append(testing._diff(torch.from_numpy(g), torch.from_numpy(np.array(r))))
    assert diffs and testing.within_tie_bound(diffs)
    np.testing.assert_allclose(port_env[out], ref_env[out], rtol=0,
                               atol=testing.SOFTMAX_ATOL)


# ---- port <-> port ----------------------------------------------------------------

def test_port_round_trip_is_the_same_graph(tmp_path):
    g = _port_graph()
    assert any(op.attrs.get("kernel") == "cuda" for op in g.ops)
    path = str(tmp_path / "m.pnb")
    p_artifact.save(g, path)
    g2 = p_artifact.load(path)
    assert _meta_json(p_artifact.graph_to_meta(g2)) == _meta_json(p_artifact.graph_to_meta(g))
    assert [op.attrs.get("kernel") for op in g2.ops] == [op.attrs.get("kernel") for op in g.ops]
    _same_weights(g.weights, g2.weights)


def test_predictor_save_and_load_predictor(tmp_path, monkeypatch):
    """The light path on the CPU: bit-identical outputs, int8 weights kept,
    and no pass run while loading."""
    pred = create_predictor(p_mnv1.build(**KW), quant=P.QuantConfig(),
                            calib_batches=[_feed(1)], device="cpu")
    feed = _feed(2)
    want = pred.run(feed)[pred.output_names[0]]
    path = str(tmp_path / "m.pnb")
    pred.save(path)
    runs = []
    orig = pass_manager.PassManager.run
    monkeypatch.setattr(pass_manager.PassManager, "run",
                        lambda self, g, **kw: runs.append(1) or orig(self, g, **kw))
    loaded = load_predictor(path, device="cpu")
    got = loaded.run(feed)[loaded.output_names[0]]
    assert runs == []
    assert torch.equal(got, want)
    assert loaded.device == CPU and isinstance(loaded, Predictor)
    assert any(w.dtype == np.int8 for w in loaded.graph.weights.values())


# ---- across the packages -------------------------------------------------------------

def test_reference_file_loads_and_runs_in_the_port(tmp_path):
    gr = _ref_graph()
    path = str(tmp_path / "ref.pnb")
    r_artifact.save(gr, path)
    gp = p_artifact.load(path)
    _same_weights(gr.weights, gp.weights)
    feed = _feed(3)
    assert_runs_agree(_ref_capture(gr, feed), _port_capture(gp, feed), gr.outputs[0])


def test_port_file_loads_and_runs_in_the_reference(tmp_path):
    gp = _port_graph()
    path = str(tmp_path / "port.pnb")
    p_artifact.save(gp, path)
    gr = r_artifact.load(path)
    _same_weights(gp.weights, gr.weights)
    feed = _feed(4)
    assert_runs_agree(_ref_capture(gr, feed), _port_capture(gp, feed), gp.outputs[0])


def test_the_same_graph_writes_the_same_bytes(tmp_path):
    """The reference's optimized graph carried across, written by each
    package: the two files are byte-identical."""
    gr = _ref_graph()
    for op in gr.ops[:4]:
        op.attrs["kernel"] = "pallas" if op.attrs.get("enable_int8") else "xla"
    gp = graph_from_reference(r_artifact.graph_to_meta(gr), gr.weights)
    a, b = str(tmp_path / "ref.pnb"), str(tmp_path / "port.pnb")
    r_artifact.save(gr, a)
    p_artifact.save(gp, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_cuda_tags_are_written_as_pallas(tmp_path):
    """Regression guard for the one-format rule: the port's ``"cuda"`` ops
    are ``"pallas"`` in the file's meta and the reference picks the same
    kernels when it loads it.  A port tag in the file would make the
    reference run its default impl without a word."""
    gp = _port_graph()
    tags = [op.attrs.get("kernel") for op in gp.ops]
    assert tags.count("cuda") >= 14
    path = str(tmp_path / "port.pnb")
    p_artifact.save(gp, path)
    meta = p_artifact.load_meta(path)
    written = [o["attrs"].get("kernel") for o in meta["ops"]]
    assert written == [{"cuda": "pallas", "torch": "xla"}.get(t, t) for t in tags]
    assert "cuda" not in json.dumps(meta["ops"])
    gr = r_artifact.load(path)
    assert [op.attrs.get("kernel") for op in gr.ops] == written
    assert [op.attrs.get("kernel") for op in p_artifact.load(path).ops] == tags


def test_a_tag_without_counterpart_raises(tmp_path):
    gp = _port_graph()
    gp.ops[0].attrs["kernel"] = "triton"
    with pytest.raises(ValueError, match="triton"):
        p_artifact.save(gp, str(tmp_path / "x.pnb"))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_weight_only_both_ways(tmp_path, bits):
    """W16 (int16), W8 and packed W4 (int4 pairs in int8, ``pack_axis``):
    the narrow weights and their scales survive either package's file, and
    each package runs the other's file as it runs its own graph."""
    feed = _feed(5)
    gp, gr = _port_graph(weight_only=bits), _ref_graph(weight_only=bits)
    pp, pr = str(tmp_path / "p.pnb"), str(tmp_path / "r.pnb")
    p_artifact.save(gp, pp)
    r_artifact.save(gr, pr)
    with open(pp, "rb") as fa, open(pr, "rb") as fb:
        assert fa.read() == fb.read()
    for loaded in (p_artifact.load(pr), p_artifact.load(pp)):
        _same_weights(gp.weights, loaded.weights)
        for n, v in gp.vars.items():
            assert loaded.vars[n].quant == v.quant, n
        out = P.build_callable(loaded, device=CPU)(P.stage_weights(loaded, CPU), feed)
        want = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
        assert torch.equal(out[gp.outputs[0]], want[gp.outputs[0]])
    gr2 = r_artifact.load(pp)
    if bits == 4:
        assert any(v.quant is not None and v.quant.pack_axis is not None
                   for v in gr2.vars.values())
    ref = R.build_callable(gr2, platform="cpu")(R.stage_weights(gr2), feed)
    np.testing.assert_allclose(want[gp.outputs[0]].numpy(),
                               np.asarray(jax.device_get(ref[gr2.outputs[0]])),
                               rtol=0, atol=1e-5)


# ---- damaged files ---------------------------------------------------------------------

@pytest.fixture()
def saved(tmp_path):
    path = str(tmp_path / "m.pnb")
    p_artifact.save(_port_graph(), path)
    with open(path, "rb") as f:
        return path, bytearray(f.read())


def _write(path, data):
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_corrupt_blob_raises(saved):
    path, data = saved
    meta = p_artifact.load_meta(path)
    blob = max(meta["tensors"], key=lambda t: t["nbytes"])
    data[blob["offset"] + blob["nbytes"] // 2] ^= 0xFF
    _write(path, data)
    with pytest.raises(IOError, match="corrupt"):
        load_predictor(path, device="cpu")


def test_bad_magic_raises(saved):
    path, data = saved
    data[0:8] = b"NOTANNBF"
    _write(path, data)
    with pytest.raises(IOError, match="bad artifact"):
        p_artifact.load(path)


@pytest.mark.parametrize("keep", [10, 200, -64])
def test_truncated_file_raises(saved, keep):
    path, data = saved
    _write(path, data[:keep])
    with pytest.raises(IOError):
        p_artifact.load(path)


def test_meta_corruption_raises(saved):
    path, data = saved
    data[40] ^= 0x01
    _write(path, data)
    with pytest.raises(IOError, match="meta"):
        p_artifact.load(path)


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        p_artifact.load(str(tmp_path / "none.pnb"))
    assert not os.path.exists(tmp_path / "none.pnb")
