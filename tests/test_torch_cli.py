"""The port's ``opt`` CLI (``tools/cli.py``) on the CPU, through ``main(argv)``:
``compile`` on a zoo model at a small size and on the committed fluid
fixture ``tests/fixtures/mnv1_fluid``, then ``info``, ``ops``, ``passes``
and ``profile``; the artifacts load through ``load_predictor`` and in the
JAX package."""

import json
import os

import numpy as np
import pytest
import torch

from paddle_lite_tpu.core.registry import OPS as ROPS
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.runtime.predictor import load_predictor
from paddle_lite_tpu_torch.tools import cli

FLUID = os.path.join(os.path.dirname(__file__), "fixtures", "mnv1_fluid")


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """`compile --int8 --device cpu` of the fluid fixture at b2 and of the
    zoo MobileNetV1 at b2 / 32 px."""
    d = tmp_path_factory.mktemp("cli")
    paths = {"fluid": str(d / "fluid.pnb"), "zoo": str(d / "zoo.pnb")}
    cli.main(["compile", "--model", FLUID, "--int8", "--batch", "2",
              "--calib-batches", "1", "--device", "cpu", "--out", paths["fluid"]])
    cli.main(["compile", "--model", "mobilenet_v1", "--int8", "--batch", "2",
              "--image-size", "32", "--calib-batches", "1", "--device", "cpu",
              "--out", paths["zoo"]])
    return paths


@pytest.mark.parametrize("which,shape", [("fluid", (2, 3, 96, 96)), ("zoo", (2, 32, 32, 3))])
def test_compile_then_info(compiled, capsys, which, shape):
    capsys.readouterr()
    cli.main(["info", "--artifact", compiled[which]])
    info = _json_line(capsys.readouterr().out)
    assert list(info["inputs"].values()) == [list(shape)]
    assert info["int8_ops"] == 27  # 13 depthwise, 13 pointwise, the fc
    assert info["op_histogram"]["depthwise_conv2d"] == 13
    assert info["weight_bytes"] > 0


@pytest.mark.parametrize("which,shape", [("fluid", (2, 3, 96, 96)), ("zoo", (2, 32, 32, 3))])
def test_compiled_artifact_runs_in_both_packages(compiled, which, shape):
    pred = load_predictor(compiled[which], device="cpu")
    tags = [op.attrs.get("kernel") for op in pred.graph.ops]
    assert tags.count("cuda") == 27  # 14 GEMM + 13 depthwise on the card
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    out = pred.run({pred.input_names[0]: x})[pred.output_names[0]]
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)
    g = r_artifact.load(compiled[which])
    assert [op.attrs.get("kernel") for op in g.ops].count("pallas") == 27


def test_compile_prints_its_summary(tmp_path, capsys):
    out = str(tmp_path / "wo.pnb")
    cli.main(["compile", "--model", "mobilenet_v1", "--batch", "1", "--image-size", "32",
              "--weight-only", "16", "--device", "cpu", "--out", out])
    summary = _json_line(capsys.readouterr().out)
    assert summary == {"out": out, "ops": summary["ops"], "int8_ops": 0}
    g = load_predictor(out, device="cpu").graph
    assert any(w.dtype == np.int16 for w in g.weights.values())


def test_ops_lists_the_registry(capsys):
    cli.main(["ops"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(OPS.names()) == len(ROPS.names())
    names = [ln.split()[0] for ln in lines]
    assert names == OPS.names()
    conv = next(ln for ln in lines if ln.startswith("conv2d "))
    assert conv.endswith("kernels: cuda, torch")


def test_passes_lists_the_passes(capsys):
    cli.main(["passes"])
    names = capsys.readouterr().out.split()
    for p in ("quant_dequant_fuse", "conv_bn_fuse", "precision_cast", "kernel_pick"):
        assert p in names


def test_profile_on_the_cpu(capsys):
    cli.main(["profile", "--model", "mobilenet_v1", "--batch", "1", "--image-size", "32",
              "--top", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:2] == ["var", "op"] and len(lines) == 4


def test_compile_refuses_an_unknown_model(tmp_path):
    with pytest.raises(ModuleNotFoundError):
        cli.main(["compile", "--model", "no_such_model", "--device", "cpu",
                  "--out", str(tmp_path / "x.pnb")])
