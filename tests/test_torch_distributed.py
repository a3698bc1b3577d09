"""``parallel/distributed.py``, the multi-device dry run (``parallel/
dryrun.py``) and the scaling bench (``parallel/scaling_bench.py``) on the
CPU, beside the JAX package's ``tests/test_distributed_and_postprocess.py``.

The dry run and the bench spawn gloo ranks (``distributed.spawn``), each
joined within a deadline: a rank that raises or hangs fails the call,
which a test holds here too.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from paddle_lite_tpu_torch.parallel import distributed, dryrun, scaling_bench

# the rows of paddle_lite_tpu/parallel/scaling_bench.py:run_scaling
REFERENCE_ROW_KEYS = {"devices", "dp", "tp", "batch", "images_per_sec", "efficiency"}


def test_initialize_without_an_environment_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.is_primary()


def test_global_mesh_one_process():
    mesh = distributed.global_mesh(tp=1, devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    batch = {"x": np.ones((4, 3), np.float32)}
    out = distributed.host_local_batch(mesh, batch)
    assert out["x"].device == torch.device("cpu") and tuple(out["x"].shape) == (4, 3)


def test_global_mesh_validates_tp(monkeypatch):
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        distributed.global_mesh(tp=2)
    monkeypatch.setattr(distributed, "world_size", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="tp=8 exceeds local device count 4"):
        distributed.global_mesh(tp=8)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        distributed.global_mesh(tp=3)


def test_spawn_reports_a_failing_rank():
    """Every rank raises in ``global_mesh(tp=3)`` over 2 ranks."""
    with pytest.raises(RuntimeError, match="2 devices not divisible by tp=3"):
        distributed.spawn(distributed.global_mesh, 2, (3,), timeout_s=90, threads=1)


def test_spawn_fails_a_hung_rank_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within 4 s"):
        distributed.spawn(time.sleep, 1, (600,), timeout_s=4, threads=1)
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("n,dp,tp,batch", [(2, 1, 2, 2), (4, 2, 2, 4)])
def test_dryrun_multichip_on_the_cpu(n, dp, tp, batch):
    """``__graft_entry__.dryrun_multichip``'s step, with the port's kernel
    tags kept: 13 pointwise convs and the fc on ``"tp_cuda"``, the stem
    split too."""
    res = dryrun.dryrun_multichip(n, "cpu", timeout_s=150)
    assert res == {"n_devices": n, "dp": dp, "tp": tp, "batch": batch, "n_tp_ops": 14,
                   "n_split_ops": 15, "shape": [batch, dryrun.NUM_CLASSES]}


def test_scaling_bench_rows(capsys):
    rows = scaling_bench.main(["--cpu-devices", "2", "--per-device-batch", "2",
                               "--image-size", "32", "--loop", "2"])
    out = capsys.readouterr().out.splitlines()
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == REFERENCE_ROW_KEYS
        assert r["images_per_sec"] > 0 and r["batch"] == 2 * r["dp"]
    assert rows[0]["efficiency"] == 1.0
    assert any(line.startswith("scaling_bench: stops at n = 2") for line in out)
    assert json.loads(out[-1]) == rows
