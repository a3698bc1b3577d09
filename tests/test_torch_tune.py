"""The port's kernel table (``ops/kernels/{tune_cache,autotune}.py``) and
``cli tune``, on the CPU.

- The bucket keys equal the JAX package's (``_bucket``, ``_key``,
  ``_dw_key``), so a shape falls in the same bucket in both.
- The table lives in ``paddle_lite_tpu_torch/_tuning/kernels.json`` or where
  ``PLT_TORCH_AUTOTUNE_DIR`` points; a round trip keeps every field.
- The pick reads it: a ``"torch"`` entry keeps the ``"torch"`` impl, an
  unmeasured bucket keeps the kernel (the port's default, not the
  reference's XLA), the NMS kernel's ops are not table-driven.
- ``validate_in_model`` demotes a standalone winner that loses in-model
  and keeps one that wins (the reference's ``tests/test_autotune.py``
  cases under an injected ``measure``), and persists its decisions.
- ``int8_matmul.plan`` takes a stored plan and refuses one the kernel
  cannot run; the sweep's candidates all fit the block.
- Measuring needs the card: ``measure_gemm``, ``measure_dw``,
  ``sweep_gemm_blocks`` and ``cli tune`` raise on the CPU.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_lite_tpu_torch as P
from paddle_lite_tpu.ops.kernels import tune_cache as r_tune
from paddle_lite_tpu_torch import QuantConfig
from paddle_lite_tpu_torch.core.ir import Graph
from paddle_lite_tpu_torch.ops.kernels import autotune, int8_matmul, ops_cuda, select, tune_cache
from paddle_lite_tpu_torch.tools import cli
from paddle_lite_tpu_torch.tools.opt import optimize

SIZES = [0, 1, 2, 3, 5, 7, 24, 96, 127, 128, 130, 191, 192, 200, 288, 1000, 3072, 12544,
         12800, 46208, 802816]


@pytest.fixture
def table(tmp_path, monkeypatch):
    """An empty table of the test's own."""
    monkeypatch.setenv(tune_cache.ENV, str(tmp_path))
    yield tmp_path / tune_cache.TABLE
    tune_cache._read.cache_clear()


@pytest.mark.parametrize("x", SIZES)
def test_bucket_is_the_reference(x):
    assert tune_cache._bucket(x) == r_tune._bucket(x)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (64, 32, 64), (3200, 9216, 24),
                                   (4096, 1024, 3072), (802816, 32, 64), (130, 200, 1000)])
def test_key_is_the_reference(m, k, n):
    assert tune_cache._key(m, k, n) == r_tune._key(m, k, n)


@pytest.mark.parametrize("h,c,k,s", [(150, 32, 3, 1), (75, 128, 3, 2), (10, 1024, 3, 1),
                                     (19, 512, 5, 2), (7, 960, 5, 1)])
def test_dw_key_is_the_reference(h, c, k, s):
    assert tune_cache._dw_key(h, c, k, s) == r_tune._dw_key(h, c, k, s)


def test_the_table_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(tune_cache.ENV, raising=False)
    assert tune_cache.table_path() == Path(P.__file__).parent / "_tuning" / "kernels.json"
    assert ".autotune" not in str(tune_cache.table_path())


def test_table_round_trip(table):
    assert tune_cache._load() == {} and tune_cache.lookup_gemm(128, 64, 128) is None
    entry = {"winner": "torch", "cuda_us": 12.5, "torch_us": 10.0,
             "card": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    tune_cache._store({tune_cache._key(128, 64, 128): entry,
                       tune_cache._dw_key(19, 512, 3, 1): dict(entry, winner="cuda")})
    assert table.is_file() and [p.name for p in table.parent.iterdir()] == [table.name]
    assert tune_cache.lookup_gemm(130, 64, 128) == "torch"  # the same bucket
    assert tune_cache.lookup_dw(19, 512, 3, 1) == "cuda"
    assert tune_cache.lookup_dw(19, 512, 3, 2) is None
    # a later store merges: the entry's other fields stay
    tune_cache._store({tune_cache._key(128, 64, 128): {"winner": "cuda"}})
    got = json.loads(table.read_text())[tune_cache._key(128, 64, 128)]
    assert got == dict(entry, winner="cuda")
    assert tune_cache.lookup_gemm(128, 64, 128) == "cuda"


def _conv_graph(seed: int = 7):
    rng = np.random.default_rng(seed)
    b = P.GraphBuilder("t", seed=seed)
    x = b.input("x", (4, 8, 8, 64))
    y = b.conv_bn_act(x, 128, 1, act="relu")
    y = b.conv_bn_act(y, 128, 3, padding=1, act="relu")
    b.mark_output(y)
    g = b.build()
    feed = {"x": rng.normal(size=(4, 8, 8, 64)).astype(np.float32)}
    optimize(g, quant=QuantConfig(), calib_batches=[feed], device="cpu")
    return g, feed


def _convs(g):
    return [op for op in g.topological_order() if op.op_type == "conv2d"]


def test_gemm_problem_is_the_im2col_rows():
    g, feed = _conv_graph()
    pw, k3 = _convs(g)
    assert autotune._gemm_problem(g, pw) == (4 * 8 * 8, 64, 128)
    x = torch.zeros(g.vars[k3.input("Input")].shape, dtype=torch.int8)
    rows = ops_cuda.im2col_nhwc(x, 3, 3, k3.attrs["strides"], k3.attrs["paddings"])
    assert autotune._gemm_problem(g, k3) == tuple(rows.shape) + (128,)


def test_unmeasured_bucket_keeps_the_kernel(table):
    g, _ = _conv_graph()
    assert [op.attrs.get("kernel") for op in _convs(g)] == ["cuda", "cuda"]


def test_torch_entry_demotes_its_bucket(table):
    m, k, n = 4 * 8 * 8, 64, 128
    tune_cache._store({tune_cache._key(m, k, n): {"winner": "torch"}})
    g, _ = _conv_graph()
    pw, k3 = _convs(g)
    assert pw.attrs.get("kernel") is None and k3.attrs.get("kernel") == "cuda"
    tune_cache._store({tune_cache._key(m, k, n): {"winner": "cuda"}})
    g, _ = _conv_graph()
    assert [op.attrs.get("kernel") for op in _convs(g)] == ["cuda", "cuda"]


def test_depthwise_bucket_reads_the_table(table):
    b = P.GraphBuilder("dw", seed=3)
    x = b.input("x", (2, 8, 8, 16))
    y = b.conv_bn_act(x, 16, 3, padding=1, depthwise=True, act="relu")
    y = b.conv_bn_act(y, 32, 1, act="relu")
    b.mark_output(y)
    g = b.build()
    feed = {"x": np.random.default_rng(3).normal(size=(2, 8, 8, 16)).astype(np.float32)}
    optimize(g, quant=QuantConfig(), calib_batches=[feed], device="cpu")
    dw = next(op for op in g.ops if op.op_type == "depthwise_conv2d")
    assert dw.attrs.get("kernel") == "cuda"
    assert tune_cache._op_table_key(g, dw) == tune_cache._dw_key(8, 16, 3, 1)
    tune_cache._store({tune_cache._dw_key(8, 16, 3, 1): {"winner": "torch"}})
    assert select.choose_kernel(g, dw) is None


@pytest.mark.parametrize("op_type", ["multiclass_nms", "multiclass_nms2", "generate_proposals"])
def test_nms_ops_are_not_table_driven(table, op_type):
    g = Graph("nms")
    op = g.add_op(op_type, {}, {})
    assert tune_cache._op_table_key(g, op) is None
    tune_cache._store({tune_cache._key(1, 1, 1): {"winner": "torch"}})
    assert select.choose_kernel(g, op) == "cuda"


@pytest.mark.parametrize("in_model,want", [((100.0, 50.0), "torch"), ((50.0, 100.0), "cuda"),
                                           ((99.5, 100.0), "torch")])
def test_validate_in_model(table, in_model, want):
    """Items/s (kernel demoted, kernel kept): a kernel that loses in-model is
    demoted, one that wins by more than 1 % stays, a tie goes to torch."""
    g, feed = _conv_graph()
    pw, _ = _convs(g)
    key = tune_cache._key(4 * 8 * 8, 64, 128)
    tune_cache._store({key: {"winner": "cuda", "cuda_us": 1.0, "torch_us": 2.0}})
    demoted, kept = in_model

    def measure(graph, _feed):
        return demoted if pw.attrs.get("kernel") is None else kept

    decisions = tune_cache.validate_in_model(g, feed, measure=measure)
    assert decisions[key] == want
    assert pw.attrs.get("kernel") == ("cuda" if want == "cuda" else None)
    stored = json.loads(table.read_text())[key]
    assert stored["winner"] == want and stored["cuda_us"] == 1.0
    assert stored["in_model"]["with_torch"] == demoted
    g2, _ = _conv_graph()
    assert _convs(g2)[0].attrs.get("kernel") == ("cuda" if want == "cuda" else None)


def test_validate_in_model_without_kernel_ops_measures_nothing(table):
    g, feed = _conv_graph()
    for op in g.ops:
        op.attrs.pop("kernel", None)
    assert tune_cache.validate_in_model(g, feed, measure=lambda *a: 1 / 0) == {}


def test_plan_takes_a_stored_plan(table):
    m, k, n = 4096, 1024, 3072
    default = int8_matmul.default_plan(m, k, n, False)
    assert int8_matmul.plan(m, k, n, False) == default
    tune_cache._store({"blocks:" + tune_cache._key(m, k, n): {
        "plan": [128, 128, 2], "out_i8": False, "us": 1.0}})
    got = int8_matmul.plan(m, k, n, False)
    assert (got.bn, got.bk, got.warpgroups) == (128, 128, 2) and got != default
    assert got == int8_matmul.plan_of(m, k, n, False, 128, 128, 2)
    assert got.smem_bytes <= int8_matmul.SMEM_LIMIT and got.tiles == 32 * 24
    # swept for fp32 out: an int8-out problem of the bucket keeps the heuristic
    assert int8_matmul.plan(m, k, n, True) == int8_matmul.default_plan(m, k, n, True)


@pytest.mark.parametrize("stored", [[256, 128, 2], [48, 64, 1], [128, 96, 1], [64, 64, 3]])
def test_plan_refuses_an_infeasible_stored_plan(table, stored):
    m, k, n = 4096, 1024, 3072
    tune_cache._store({"blocks:" + tune_cache._key(m, k, n): {"plan": stored, "out_i8": False}})
    with pytest.raises(ValueError, match="int8_matmul"):
        int8_matmul.plan(m, k, n, False)


@pytest.mark.parametrize("m,k,n,out_i8", [(4096, 1024, 3072, False), (4096, 4096, 1024, False),
                                          (4096, 1024, 4096, True), (3200, 9216, 24, False),
                                          (32, 1024, 2, False)])
def test_plan_candidates_fit_and_hold_todays_plan(m, k, n, out_i8):
    cands = autotune.plan_candidates(m, k, n, out_i8)
    d = int8_matmul.default_plan(m, k, n, out_i8)
    assert (d.bn, d.bk, d.warpgroups) in cands
    for bn, bk, wgs in cands:
        assert int8_matmul.plan_of(m, k, n, out_i8, bn, bk, wgs).smem_bytes \
            <= int8_matmul.SMEM_LIMIT


@pytest.mark.parametrize("call", [
    lambda: tune_cache.measure_gemm(32, 64, 32),
    lambda: tune_cache.measure_gemm(32, 64, 32, device="cpu"),
    lambda: tune_cache.measure_dw(1, 8, 16, device="cpu"),
    lambda: tune_cache.sweep_gemm_blocks(64, 64, 64, device="cpu"),
])
def test_measuring_raises_on_the_cpu(table, call):
    with pytest.raises(RuntimeError):
        call()
    assert not table.exists()


def test_cli_tune_raises_on_the_cpu(table):
    with pytest.raises(RuntimeError, match="measured on the card"):
        cli.main(["tune", "--model", "mobilenet_v1", "--batch", "1", "--image-size", "32",
                  "--device", "cpu", "--validate"])
    assert not table.exists()
