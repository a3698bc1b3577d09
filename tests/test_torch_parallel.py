"""The tensor-parallel int8 GEMM (``parallel/tp_cuda.py``) against the JAX
package's ``parallel/tp_pallas.py``, and the GEMM's int32 output kind.

The port's side runs in four spawned gloo ranks on the CPU (one spawn for
the module; meshes 1x4 and 2x2 in it, so the model axis has 4 and 2
ranks), which import only ``paddle_lite_tpu_torch``
(``testing/parallel.tp_gemms``).  The reference runs in this process on
conftest's virtual CPU devices, its Pallas kernel in interpret mode.

Tolerances, and why:
- column-parallel, fp32 out: rtol / atol 1e-6 (the same int32 accumulator
  scaled, biased once in fp32 by both; only XLA's order of the two fp32
  operations could differ);
- column-parallel, int8 out: bit-equal (both requantize by
  ``y * fp32(1 / s)``, the Pallas epilogue);
- row-parallel where the reference's fp32 partials are exact (|partial| <
  2^24): fp32 out within 1e-6; int8 out within 1 LSB in at most
  ``testing.TIE_FRACTION`` of elements (the reference's row epilogue
  divides by s, the port's multiplies by fp32(1 / s), as the kernel does);
- where a partial passes 2^24 the port equals the exact product and the
  reference does not (its fp32 partials round).
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from paddle_lite_tpu.parallel.tp_pallas import (column_parallel_int8_matmul as r_col,
                                                row_parallel_int8_matmul as r_row)
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.ops.kernels import autotune, int8_matmul as km, tune_cache
from paddle_lite_tpu_torch.parallel import distributed, tp_cuda
from paddle_lite_tpu_torch.parallel.sharding import Mesh as PMesh, MeshConfig
from paddle_lite_tpu_torch.testing import parallel as tparallel

MESHES = ((1, 4), (2, 2))
SPAWN_TIMEOUT_S = 150


def _operands(rng, m, k, n):
    x = rng.integers(-20, 20, (m, k), dtype=np.int8)
    w = rng.integers(-20, 20, (k, n), dtype=np.int8)
    eff = rng.uniform(1e-3, 2e-3, (n,)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    return dict(x=x, w=w, eff=eff, bias=bias)


def _fault_operands():
    """K = 2 × 1,100: shard 0's partial at (0, 0) is 2^24 + 1 (odd, above
    2^24: fp32 rounds it to 2^24), shard 1's is -(2^24) + 2 (exact); the
    exact sum is 3, the reference's fp32 sum 2."""
    m, k, n = 4, 2200, 8
    x = np.zeros((m, k), np.int8)
    w = np.zeros((k, n), np.int8)
    x[0, :1040], w[:1040, 0] = 127, 127                 # 1040 · 16129 = 16,774,160
    x[0, 1040], w[1040, 0] = 127, 24                    # + 3,048
    x[0, 1041], w[1041, 0] = 9, 1                       # + 9 → 2^24 + 1
    x[0, 1100:2140], w[1100:2140, 0] = 127, -127        # -16,774,160
    x[0, 2140], w[2140, 0] = 127, -24                   # - 3,048
    x[0, 2141], w[2141, 0] = 6, -1                      # - 6 → -(2^24) + 2
    rng = np.random.default_rng(5)
    x[1:] = rng.integers(-3, 4, (m - 1, k))
    w[:, 1:] = rng.integers(-3, 4, (k, n - 1))
    return dict(x=x, w=w, eff=np.ones(n, np.float32))


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(0)
    pair = _operands(rng, 16, 32, 64)
    return {"col": _operands(rng, 32, 64, 128), "row": _operands(rng, 32, 64, 32),
            "pair": dict(x=pair["x"], w1=pair["w"], eff1=pair["eff"], b1=pair["bias"],
                         w2=rng.integers(-20, 20, (64, 32), dtype=np.int8),
                         eff2=rng.uniform(1e-3, 2e-3, (32,)).astype(np.float32)),
            "fault": _fault_operands()}


@pytest.fixture(scope="module")
def ranks(problems):
    """Every rank's results (four gloo ranks, one spawn)."""
    return distributed.spawn(tparallel.tp_gemms, 4, (problems, MESHES),
                             timeout_s=SPAWN_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def port(ranks):
    return ranks[0]


def _jmesh(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("data", "model"))


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _within_ties(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return d.max() <= testing.TIE_LSB and (d > 0).sum() <= max(
        testing.TIE_COUNT, testing.TIE_FRACTION * d.size)


def test_every_rank_holds_the_whole_result(ranks):
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("shape", MESHES)
def test_column_parallel_fp32(port, problems, shape):
    c = problems["col"]
    ref = np.asarray(r_col(_jmesh(shape), c["x"], c["w"], c["eff"], c["bias"], interpret=True))
    got = port["col_f32 " + _tag(shape)]
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_column_parallel_relu_requant_bit_equal(port, problems, shape):
    c = problems["col"]
    ref = np.asarray(r_col(_jmesh(shape), c["x"], c["w"], c["eff"], c["bias"], act="relu",
                           out_scale=0.05, interpret=True))
    got = port["col_i8 " + _tag(shape)]
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", MESHES)
def test_row_parallel_all_reduce(port, problems, shape):
    r = problems["row"]
    ref = np.asarray(r_row(_jmesh(shape), r["x"], r["w"], r["eff"], r["bias"], interpret=True))
    np.testing.assert_allclose(port["row_f32 " + _tag(shape)], ref, rtol=1e-6, atol=1e-6)
    ref8 = np.asarray(r_row(_jmesh(shape), r["x"], r["w"], r["eff"], r["bias"], act="relu",
                            out_scale=0.05, interpret=True))
    got8 = port["row_i8 " + _tag(shape)]
    assert got8.dtype == np.int8 and _within_ties(got8, ref8)


@pytest.mark.parametrize("shape", MESHES)
def test_row_parallel_reduce_scatter(port, problems, shape):
    r = problems["row"]
    ref = np.asarray(r_row(_jmesh(shape), r["x"], r["w"], r["eff"], r["bias"],
                           scatter_batch=True, interpret=True))
    got = port["row_scatter " + _tag(shape)]
    assert got.shape == (32, 32)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_column_then_row(port, problems, shape):
    """The Megatron pair: one collective (the row step's int32 sum)."""
    p = problems["pair"]
    mesh = _jmesh(shape)
    mid = np.asarray(r_col(mesh, p["x"], p["w1"], p["eff1"], p["b1"], act="relu",
                           out_scale=0.05, interpret=True))
    ref = np.asarray(r_row(mesh, mid, p["w2"], p["eff2"], interpret=True))
    np.testing.assert_allclose(port["pair " + _tag(shape)], ref, rtol=1e-6, atol=1e-6)
    # and the single-device pair of GEMMs on the port's plain versions
    one = km.int8_matmul_plain(
        km.int8_matmul_plain(torch.from_numpy(p["x"]), torch.from_numpy(p["w1"]), p["eff1"],
                             torch.from_numpy(p["b1"]), act="relu", out_scale=0.05),
        torch.from_numpy(p["w2"]), p["eff2"])
    np.testing.assert_array_equal(port["pair " + _tag(shape)], one.numpy())


def test_row_parallel_sums_int32_partials_where_the_reference_rounds(port, problems):
    """A partial of 2^24 + 1 (K shard 1,100 >= 1,041): the port is the
    exact product; the reference's fp32 partials give 2 where it is 3."""
    f = problems["fault"]
    exact = (f["x"].astype(np.int64) @ f["w"].astype(np.int64)).astype(np.float32)
    assert exact[0, 0] == 3.0
    got = port["fault 2x2"]
    np.testing.assert_array_equal(got, exact)
    ref = np.asarray(r_row(_jmesh((2, 2)), f["x"], f["w"], f["eff"], interpret=True))
    assert ref[0, 0] == 2.0 and not np.array_equal(ref, exact)


def _cpu_mesh(data=1, model=1, rank=0):
    """A mesh's shape and coordinates without a process group (slicing
    needs no collective)."""
    return PMesh({"data": data, "model": model}, rank, torch.device("cpu"), "gloo",
                 {"data": None, "model": None})


def test_shards_validate_divisibility():
    mesh = MeshConfig().build(["cpu"])
    four = _cpu_mesh(model=4)
    with pytest.raises(ValueError, match="divisible"):
        tp_cuda.column_shard(four, torch.zeros((8, 10), dtype=torch.int8), torch.ones(10))
    with pytest.raises(ValueError, match="divisible"):
        tp_cuda.row_shard(four, torch.zeros((4, 6), dtype=torch.int8),
                          torch.zeros((6, 8), dtype=torch.int8))
    # a 1x1 mesh: the whole operands
    w, eff, b = tp_cuda.column_shard(mesh, torch.ones((8, 10), dtype=torch.int8), 0.5)
    assert w.shape == (8, 10) and eff.shape == (10,) and b is None


# ---- the GEMM's int32 output kind ------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 2, 1), (64, 64, 64), (33, 130, 50), (64, 1041, 24)])
def test_i32_plain_is_the_exact_product(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    got = km.int8_matmul_i32(torch.from_numpy(x), torch.from_numpy(w))  # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("value", [127, -128])
def test_i32_plain_saturating_k4608(value):
    """K = 4,608 (ResNet-50's 3x3x512): every product at its extreme."""
    m, k, n = 16, 4608, 8
    x = np.full((m, k), value, np.int8)
    x[::2] = 127
    w = np.full((k, n), -128, np.int8)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    got = km.int8_matmul_i32_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), exact)


def test_i32_refuses_a_k_that_can_overflow():
    assert km.I32_MAX_K == 131071 and km.I32_MAX_K * 128 * 128 < 2 ** 31
    x = torch.zeros((1, km.I32_MAX_K + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        km.int8_matmul_i32_plain(x, torch.zeros((km.I32_MAX_K + 1, 1), dtype=torch.int8))


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("bn", km.BN_CHOICES)
@pytest.mark.parametrize("bk", [32, 64, 128])
def test_i32_tile_takes_fp32_bytes(bm, bn, bk):
    assert km.smem_bytes(bm, bn, bk, km.OUT_I32) == km.smem_bytes(bm, bn, bk, km.OUT_F32)
    assert km.smem_bytes(bm, bn, bk, True) == km.smem_bytes(bm, bn, bk, km.OUT_I8)
    assert km.smem_bytes(bm, bn, bk, False) == km.smem_bytes(bm, bn, bk, km.OUT_F32)


@pytest.mark.parametrize("m,k,n", [(4096, 2048, 1024), (12544, 512, 256), (3136, 1024, 512),
                                   (777, 130, 50), (256, 4608, 64), (100, 18, 8)])
def test_i32_plan_is_the_fp32_plan(m, k, n):
    assert km.default_plan(m, k, n, km.OUT_I32) == km.default_plan(m, k, n, km.OUT_F32)
    assert autotune.plan_candidates(m, k, n, km.OUT_I32) == \
        autotune.plan_candidates(m, k, n, km.OUT_F32)
    p = km.default_plan(m, k, n, km.OUT_I32)
    assert (n * 4) % p.out_width == 0  # an int32 row is 4 bytes an output


@pytest.fixture
def table(tmp_path, monkeypatch):
    monkeypatch.setenv(tune_cache.ENV, str(tmp_path))
    yield
    tune_cache._read.cache_clear()


@pytest.mark.parametrize("out_i8", [False, True])
def test_tuning_keys_read_as_before(table, out_i8):
    """A stored entry names its kind by ``"out_i8"`` as before the int32
    kind existed; the kind argument takes an ``OUT_*`` or a bool."""
    m, k, n = 4096, 1024, 3072
    tune_cache._store({"blocks:" + tune_cache._key(m, k, n):
                       {"plan": [128, 128, 2], "out_i8": out_i8}})
    kind = km.OUT_I8 if out_i8 else km.OUT_F32
    for other in (km.OUT_F32, km.OUT_I8, km.OUT_I32):
        got = tune_cache.lookup_blocks(m, k, n, other)
        assert got == ((128, 128, 2) if other == kind else None), other
    assert tune_cache.lookup_blocks(m, k, n, out_i8) == (128, 128, 2)
    assert km.plan(m, k, n, kind) == km.plan_of(m, k, n, kind, 128, 128, 2)


@pytest.mark.parametrize("out_i8", [False, True])
def test_i32_plan_is_the_default_whatever_is_stored(table, out_i8):
    """No int32 GEMM is swept: its plan is the heuristic (the fp32 plan)
    even where the bucket holds a swept fp32 or int8 plan."""
    m, k, n = 4096, 1024, 3072
    tune_cache._store({"blocks:" + tune_cache._key(m, k, n):
                       {"plan": [64, 32, 1], "out_i8": out_i8}})
    assert km.plan(m, k, n, km.OUT_I32) == km.default_plan(m, k, n, km.OUT_F32)
    assert km.plan(m, k, n, km.OUT_I32) != km.plan_of(m, k, n, km.OUT_I32, 64, 32, 1)


# ---- the package stands alone and registers nothing -------------------------------

PARALLEL_MODULES = ("__init__", "sharding", "tp_cuda", "tp_ops", "distributed",
                    "scaling_bench", "dryrun")


@pytest.mark.parametrize("name", PARALLEL_MODULES)
def test_parallel_module_imports_no_jax(name):
    import ast

    import paddle_lite_tpu_torch

    src = Path(paddle_lite_tpu_torch.__file__).parent / "parallel" / f"{name}.py"
    for node in ast.walk(ast.parse(src.read_text())):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_lite_tpu"), (name, mod)


IMPORT_CHECK = r"""
from paddle_lite_tpu_torch.core.registry import OPS
import paddle_lite_tpu_torch.ops  # every op's impls
before = {n: sorted(OPS.get(n).impls) for n in OPS.names()}
import paddle_lite_tpu_torch.parallel
import paddle_lite_tpu_torch.parallel.tp_ops, paddle_lite_tpu_torch.parallel.scaling_bench
import paddle_lite_tpu_torch.parallel.dryrun, paddle_lite_tpu_torch.testing.parallel
after = {n: sorted(OPS.get(n).impls) for n in OPS.names()}
import sys
assert before == after, [n for n in after if before.get(n) != after[n]]
assert not any(m == "jax" or m.startswith(("jax.", "paddle_lite_tpu.")) for m in sys.modules)
print("unchanged", len(after))
"""


def test_importing_parallel_registers_nothing():
    """In a fresh process, so that no earlier import hides a registration."""
    r = subprocess.run([sys.executable, "-c", IMPORT_CHECK], capture_output=True, text=True,
                       timeout=120, cwd=str(Path(__file__).parents[1]))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("unchanged")
