"""The port's core against the JAX package: import isolation, the registry,
device rules, the model builder, graph interop and the numpy passes.

Inputs are made with numpy from a seed and handed to both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.pass_manager import PassManager as RPassManager
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.quant.calibrate import CalibrationResult as RCalib
from paddle_lite_tpu.quant.quantize_pass import ptq_quantize as r_ptq
from paddle_lite_tpu.tools.opt import FUSION_PASSES as R_FUSION
from paddle_lite_tpu_torch.core.pass_manager import PassManager
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1 as p_mnv1
from paddle_lite_tpu_torch.quant.calibrate import CalibrationResult
from paddle_lite_tpu_torch.quant.quantize_pass import ptq_quantize
from paddle_lite_tpu_torch.runtime.predictor import Predictor, create_predictor
from paddle_lite_tpu_torch.tools.opt import FUSION_PASSES, optimize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _assert_same_graph(gr, gp, *, skip_attrs=()):
    """Ops, attrs, var shapes / precisions / quant and weights identical."""
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        ka = {k: v for k, v in a.attrs.items() if k not in skip_attrs}
        kb = {k: v for k, v in b.attrs.items() if k not in skip_attrs}
        assert ka == kb, (a.op_type, ka, kb)
    assert gr.inputs == gp.inputs and gr.outputs == gp.outputs
    assert sorted(gr.vars) == sorted(gp.vars)
    for n, v in gr.vars.items():
        w = gp.vars[n]
        assert v.shape == w.shape and v.is_weight == w.is_weight, n
        assert v.precision.value == w.precision.value, n
        assert (v.quant is None) == (w.quant is None), n
        if v.quant is not None:
            assert v.quant.scale == w.quant.scale and v.quant.axis == w.quant.axis
    assert sorted(gr.weights) == sorted(gp.weights)
    for n in gr.weights:
        a, b = np.asarray(gr.weights[n]), np.asarray(gp.weights[n])
        assert a.dtype == b.dtype and np.array_equal(a, b), n


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import paddle_lite_tpu_torch\n"
        "import paddle_lite_tpu_torch.runtime.predictor\n"
        "import paddle_lite_tpu_torch.tools.opt\n"
        "import paddle_lite_tpu_torch.formats.interop\n"
        "import paddle_lite_tpu_torch.models.mobilenet_v1\n"
        "import paddle_lite_tpu_torch.models.mobilenet_v3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'paddle_lite_tpu' or m.startswith('paddle_lite_tpu.')]\n"
        "assert 'paddle_lite_tpu_torch' in sys.modules\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_unknown_kernel_tag_raises():
    # the reference falls back to "xla" here (registry.py:39-45); the port
    # must not run another kernel than the one stamped
    with pytest.raises(KeyError, match="no 'pallas' implementation"):
        OPS.get("conv2d").impl_for("pallas")
    assert OPS.get("conv2d").impl_for(None) is OPS.get("conv2d").impls["torch"]
    g = p_mnv1.build(batch=1, image_size=32, width_mult=0.25, seed=0)
    g.ops[0].attrs["kernel"] = "bogus"
    with pytest.raises(KeyError, match="bogus"):
        Predictor(g, device="cpu")


def test_entry_points_need_cpu_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = p_mnv1.build(batch=1, image_size=32, width_mult=0.25, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_predictor(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize(g)
    pred = create_predictor(g, device="cpu")
    out = pred.run({"image": np.zeros((1, 32, 32, 3), np.float32)})
    assert out[g.outputs[0]].device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0),
    dict(batch=1, image_size=64, width_mult=1.0, seed=3),
])
def test_mobilenet_build_identical(kw):
    _assert_same_graph(r_mnv1.build(**kw), p_mnv1.build(**kw))


def test_fusion_passes_identical():
    assert FUSION_PASSES == R_FUSION
    kw = dict(batch=2, image_size=32, width_mult=0.5, num_classes=10, seed=1)
    gr, gp = r_mnv1.build(**kw), p_mnv1.build(**kw)
    RPassManager(R_FUSION).run(gr)
    PassManager(FUSION_PASSES).run(gp)
    _assert_same_graph(gr, gp)


def test_ptq_quantize_identical_for_same_scales():
    """Same calibration scales in -> bit-identical int8 weights, scales,
    attrs and precisions out (the quantize pass is a numpy copy)."""
    kw = dict(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=2)
    gr, gp = r_mnv1.build(**kw), p_mnv1.build(**kw)
    RPassManager(R_FUSION).run(gr)
    PassManager(FUSION_PASSES).run(gp)
    rng = np.random.default_rng(0)
    scales = {n: float(rng.uniform(0.01, 0.1)) for n in sorted(gr.vars)
              if not gr.vars[n].is_weight}
    r_ptq(gr, RCalib(scales=dict(scales)), R.QuantConfig())
    ptq_quantize(gp, CalibrationResult(scales=dict(scales)), P.QuantConfig())
    _assert_same_graph(gr, gp)


def test_graph_from_reference_roundtrip_and_tags():
    kw = dict(batch=1, image_size=32, width_mult=0.25, num_classes=10, seed=0)
    gr = r_mnv1.build(**kw)
    gr.ops[0].attrs["kernel"] = "xla"
    gr.ops[1].attrs["kernel"] = "pallas"
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    assert gp.ops[0].attrs["kernel"] == "torch"
    assert gp.ops[1].attrs["kernel"] == "cuda"
    _assert_same_graph(gr, gp, skip_attrs=("kernel",))
    gr.ops[2].attrs["kernel"] = "tp_pallas"
    with pytest.raises(ValueError, match="tp_pallas"):
        graph_from_reference(artifact.graph_to_meta(gr), gr.weights)


def test_precision_torch_dtypes():
    assert P.Precision.INT8.torch_dtype is torch.int8
    assert P.Precision.BF16.torch_dtype is torch.bfloat16
    assert P.Precision.FP32.torch_dtype is torch.float32


def test_island_dtype_not_ported():
    """bf16 islands run (fp32 outputs, bf16 values between ops); an island
    dtype the port does not have (float16) raises instead of running fp32."""
    g = p_mnv1.build(batch=1, image_size=32, width_mult=0.25, seed=0)
    g.meta["island_dtype"] = "bfloat16"
    w = P.stage_weights(g, CPU)
    assert {v.dtype for v in w.values()} == {torch.bfloat16}
    env = {}
    feed = {"image": np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)}
    out = P.build_callable(g, device=CPU, capture=env.__setitem__)(w, feed)
    assert out[g.outputs[0]].dtype == torch.float32
    assert {v.dtype for v in env.values()} == {torch.bfloat16}
    g.meta["island_dtype"] = "float16"
    with pytest.raises(NotImplementedError, match="island"):
        P.build_callable(g, device=CPU)


def test_fp32_exact_shared_across_threads():
    """Overlapping runs on many threads: TF32 stays off inside every one,
    and the saved flags come back once the last run leaves."""
    import threading
    import time

    from paddle_lite_tpu_torch.core.device import fp32_exact

    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    seen_on = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(50):
                with fp32_exact():
                    time.sleep(0)
                    seen_on.append(torch.backends.cudnn.allow_tf32
                                   or torch.backends.cuda.matmul.allow_tf32)

        threads = [threading.Thread(target=worker) for _ in range(4 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(seen_on) == 50 * len(threads) and not any(seen_on)
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
