"""Rank functions for checking the parallel layer with spawned ranks.

Each runs in a rank of a process group that ``parallel.distributed.spawn``
started (gloo on the CPU in the tests, gloo ranks sharing one card in
``chip_smoke.py``), imports only this package, and returns numpy arrays
for the caller to hold against a single-device run or the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..parallel import tp_cuda
from ..parallel.sharding import MeshConfig, ShardedPredictor


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tp_gemms(problems: Dict[str, dict], meshes: Sequence[Tuple[int, int]],
             device: str = "cpu") -> Dict[str, np.ndarray]:
    """The tensor-parallel GEMMs on every mesh (data, model) of `meshes`,
    each result whole (gathered over the model group) as numpy, keyed
    ``"{case} {dp}x{tp}"``.  `problems` holds numpy operands:

    - ``"col"``: x (M, K), w (K, N), eff, bias: column-parallel with fp32
      out (``col_f32``) and with relu and requant at 0.05 (``col_i8``);
    - ``"row"``: x, w, eff, bias: row-parallel summed by all_reduce
      (``row_f32``, ``row_i8`` with relu and requant at 0.05) and by
      reduce_scatter over M (``row_scatter``);
    - ``"pair"``: x, w1, eff1, b1, w2, eff2: column (relu, requant 0.05)
      then row on its feature-split output (``pair``);
    - ``"fault"`` (meshes with model 2 only): x, w, eff: row-parallel with
      fp32 out (``fault``)."""
    dev = torch.device(device)
    world = int(np.prod(meshes[0]))
    out: Dict[str, np.ndarray] = {}
    for dp, tp in meshes:
        mesh = MeshConfig(data=dp, model=tp).build([device] * world, backend="gloo")
        tag = f"{dp}x{tp}"

        def whole(y, dim=-1):
            return mesh.all_gather(y, "model", dim=dim).cpu().numpy()

        c = {k: _t(v, dev) for k, v in problems["col"].items()}
        w, eff, b = tp_cuda.column_shard(mesh, c["w"], c["eff"], c["bias"])
        out[f"col_f32 {tag}"] = whole(tp_cuda.column_parallel_int8_matmul(mesh, c["x"], w, eff, b))
        out[f"col_i8 {tag}"] = whole(tp_cuda.column_parallel_int8_matmul(
            mesh, c["x"], w, eff, b, act="relu", out_scale=0.05))

        r = {k: _t(v, dev) for k, v in problems["row"].items()}
        xs, ws = tp_cuda.row_shard(mesh, r["x"], r["w"])
        out[f"row_f32 {tag}"] = tp_cuda.row_parallel_int8_matmul(
            mesh, xs, ws, r["eff"], r["bias"]).cpu().numpy()
        out[f"row_i8 {tag}"] = tp_cuda.row_parallel_int8_matmul(
            mesh, xs, ws, r["eff"], r["bias"], act="relu", out_scale=0.05).cpu().numpy()
        out[f"row_scatter {tag}"] = whole(tp_cuda.row_parallel_int8_matmul(
            mesh, xs, ws, r["eff"], r["bias"], scatter_batch=True), dim=0)

        p = {k: _t(v, dev) for k, v in problems["pair"].items()}
        w1, e1, b1 = tp_cuda.column_shard(mesh, p["w1"], p["eff1"], p["b1"])
        mid = tp_cuda.column_parallel_int8_matmul(mesh, p["x"], w1, e1, b1, act="relu",
                                                  out_scale=0.05)
        w2 = mesh.local_slice(p["w2"], "model", 0).contiguous()  # mid's K shard
        out[f"pair {tag}"] = tp_cuda.row_parallel_int8_matmul(
            mesh, mid, w2, p["eff2"]).cpu().numpy()

        if tp == 2:
            f = {k: _t(v, dev) for k, v in problems["fault"].items()}
            xs, ws = tp_cuda.row_shard(mesh, f["x"], f["w"])
            out[f"fault {tag}"] = tp_cuda.row_parallel_int8_matmul(
                mesh, xs, ws, f["eff"]).cpu().numpy()
    return out


def sharded_runs(graph_path: str, feed: Dict[str, np.ndarray],
                 meshes: Sequence[Tuple[int, int]], device: str = "cpu") -> List[dict]:
    """The pickled optimized graph at `graph_path` through
    :class:`ShardedPredictor` at each (data, model) mesh of `meshes` (one
    fresh copy of the graph each): the whole output, every int8
    intermediate gathered whole, the retag count and the retagged types."""
    with open(graph_path, "rb") as f:
        g0 = pickle.load(f)
    world = int(np.prod(meshes[0]))
    runs = []
    for dp, tp in meshes:
        g = copy.deepcopy(g0)
        seen: Dict[str, torch.Tensor] = {}

        def capture(name, value):
            if value.dtype == torch.int8:
                seen[name] = value

        sp = ShardedPredictor(g, MeshConfig(data=dp, model=tp), [device] * world,
                              backend="gloo", capture=capture)
        y = {k: v.cpu().numpy() for k, v in sp.run(feed).items()}
        ints = {}
        for name in sorted(seen):  # the same names, in one order, on every rank
            v = seen[name]
            if name in sp.batch_vars:
                v = sp.mesh.all_gather(v, "data", dim=0)
            ints[name] = v.cpu().numpy()
        runs.append({"mesh": (dp, tp), "out": y, "int8": ints, "n_tp_ops": sp.n_tp_ops,
                     "n_split_ops": sp.n_split_ops,
                     "tagged": sorted(op.op_type for op in g.ops
                                      if op.attrs.get("kernel") == "tp_cuda")})
    return runs


# ---- on the card: ranks sharing one card over gloo, or one rank on NCCL --------

def _counts() -> Dict[str, int]:
    from ..ops.kernels import depthwise, int8_matmul

    return {"int8_gemm": int8_matmul.launches, "int8_gemm_i32": int8_matmul.launches_i32,
            "dw_conv": depthwise.launches}


def _reset_counts() -> None:
    from ..ops.kernels import depthwise, int8_matmul

    int8_matmul.launches = int8_matmul.launches_i32 = depthwise.launches = 0


def _sync(device: torch.device) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if dist.is_initialized():
        dist.barrier()


def ffn_pair(m: int, hidden: int, ffn: int, seed: int, device: str) -> dict:
    """ERNIE's FFN as the Megatron pair over the model axis of a 1 x world
    mesh: FFN1 (hidden -> ffn, tanh-gelu, int8 out) column-parallel, FFN2
    (ffn -> hidden, fp32 out) row-parallel on kernel 1's int32 partials,
    held bit for bit against the single-device pair of ``int8_matmul``
    calls on the same operands.  Returns the launches of the sharded pair
    (counted from 0 just before it, read just after), the differing
    elements and the pair's ms on the host clock."""
    import time

    import torch.distributed as dist

    from ..ops.kernels import int8_matmul as km

    dev = torch.device(device)
    world = dist.get_world_size()
    mesh = MeshConfig(data=1, model=world).build([device] * world, backend="gloo")
    rng = np.random.default_rng(seed)
    x = _t(rng.integers(-127, 128, (m, hidden), dtype=np.int8), dev)
    w1 = _t(rng.integers(-127, 128, (hidden, ffn), dtype=np.int8), dev)
    w2 = _t(rng.integers(-127, 128, (ffn, hidden), dtype=np.int8), dev)
    e1 = _t(rng.uniform(1e-5, 2e-5, ffn).astype(np.float32), dev)
    b1 = _t(rng.normal(0, 0.5, ffn).astype(np.float32), dev)
    e2 = _t(rng.uniform(1e-4, 2e-4, hidden).astype(np.float32), dev)
    b2 = _t(rng.normal(0, 0.5, hidden).astype(np.float32), dev)
    gelu = dict(act="gelu", act_attrs={"approximate": True}, out_scale=0.02)
    w1s, e1s, b1s = tp_cuda.column_shard(mesh, w1, e1, b1)
    w2s = mesh.local_slice(w2, "model", 0).contiguous()  # the column step's K shard

    def pair():
        mid = tp_cuda.column_parallel_int8_matmul(mesh, x, w1s, e1s, b1s, **gelu)
        return tp_cuda.row_parallel_int8_matmul(mesh, mid, w2s, e2, b2)

    pair()  # warm-up: libraries loaded, set up for the card
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    got = pair()
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    counts = _counts()
    want = km.int8_matmul(km.int8_matmul(x, w1, e1, b1, **gelu), w2, e2, b2)
    return {"launches": counts, "ms": ms, "shape": list(got.shape),
            "differing": int((got != want).sum()), "max_abs_err": float((got - want).abs().max()),
            "finite": bool(torch.isfinite(got).all())}


def sharded_requests(graph, feed: Dict[str, np.ndarray], meshes: Sequence[Tuple[int, int]],
                     device: str, backend: str, requests: int) -> List[dict]:
    """`graph` (optimized) through :class:`ShardedPredictor` at each mesh
    of `meshes` on this rank: one request counted (launches from 0 just
    before it, read just after), then `requests` timed between barriers
    (rank 0's host clock).  Rank 0 also holds every int8 intermediate
    (gathered over the data group) against the single-device eager loop's
    on the same card: elements that differ and by how much."""
    import time

    import torch.distributed as dist

    from ..core.executor import build_callable, stage_weights

    dev = torch.device(device)
    world = dist.get_world_size()
    out = []
    for dp, tp in meshes:
        g = copy.deepcopy(graph)
        seen: Dict[str, torch.Tensor] = {}

        def capture(name, value):
            if value.dtype == torch.int8:
                seen[name] = value

        sp = ShardedPredictor(g, MeshConfig(data=dp, model=tp), [device] * world,
                              backend=backend, capture=capture)
        sp.run(feed)  # warm-up: per-op constants, libraries
        _sync(dev)
        _reset_counts()
        y = sp.run(feed)[g.outputs[0]]
        _sync(dev)
        counts = _counts()
        ints = {}
        for name in sorted(seen):
            v = seen[name]
            ints[name] = sp.mesh.all_gather(v, "data", dim=0) if name in sp.batch_vars else v
        seen.clear()
        t0 = time.perf_counter()
        for _ in range(requests):
            sp.run(feed)
        _sync(dev)
        secs = time.perf_counter() - t0
        row = {"mesh": [dp, tp], "backend": sp.mesh.backend, "launches": counts,
               "n_tp_ops": sp.n_tp_ops, "n_split_ops": sp.n_split_ops, "seconds": secs,
               "requests": requests, "out": y.cpu().numpy()}
        if dist.get_rank() == 0:  # the single-device eager loop, same card, same graph
            ref: Dict[str, torch.Tensor] = {}
            one = copy.deepcopy(graph)
            fn = build_callable(one, device=dev, capture=lambda n, v: ref.__setitem__(n, v)
                                if v.dtype == torch.int8 else None)
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                fn(stage_weights(one, dev), feed)
            diffs = {}
            for name, v in ints.items():
                d = (v.to(torch.int32) - ref[name].to(torch.int32)).abs()
                diffs[name] = {"numel": v.numel(), "n_diff": int((d > 0).sum()),
                               "max_diff": int(d.max()) if v.numel() else 0}
            row["int8_diffs"] = diffs
        ints.clear()
        out.append(row)
        del sp
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def card_ranks(graph, feed: Dict[str, np.ndarray], meshes: Sequence[Tuple[int, int]],
               backend: str, requests: int, device: str = "cuda:0",
               pair: Tuple[int, int, int] = None) -> dict:
    """One rank of ``chip_smoke.py``'s phase 17, every rank on `device`
    (the one card): the FFN pair (where `pair` gives its M, hidden, FFN)
    and the sharded requests."""
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    res = {}
    if pair is not None:
        res["pair"] = ffn_pair(*pair, seed=0, device=device)
    res["sharded"] = sharded_requests(graph, feed, meshes, device, backend, requests)
    return res
