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
                              backend="gloo", compiled=False, capture=capture)
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


def with_all_outputs(graph):
    """A copy of `graph` with every op output among its outputs, so that a
    compiled function returns every intermediate."""
    g = copy.deepcopy(graph)
    g.outputs = list(g.outputs) + [n for op in g.topological_order()
                                   for n in op.output_names() if n not in g.outputs]
    return g


def compiled_runs(graph_paths: Sequence[str], feeds: Sequence[Dict[str, np.ndarray]],
                  meshes: Sequence[Tuple[int, int]], device: str = "cpu") -> List[List[dict]]:
    """Each pickled optimized graph of `graph_paths`, with every
    intermediate among its outputs (:func:`with_all_outputs`), through the
    compiled :class:`ShardedPredictor` and the eager one at each (data,
    model) mesh of `meshes`, each on every feed of `feeds` in turn, and
    through the compiled one with ``use_tp_cuda=False`` on the first feed.
    By graph, then by mesh: the outputs as numpy (``"compiled"`` /
    ``"eager"`` a list by feed, ``"plain"``), whether the first compiled
    result was left unchanged by the later calls and shares no storage
    with them, the plan's segments, the static input buffers' shapes, the
    retag counts and the plain run's kernel tags."""
    world = int(np.prod(meshes[0]))
    by_graph = []
    for path in graph_paths:
        with open(path, "rb") as f:
            g0 = with_all_outputs(pickle.load(f))
        runs = []
        for dp, tp in meshes:
            mesh = MeshConfig(data=dp, model=tp)

            def make(**kw):
                return ShardedPredictor(copy.deepcopy(g0), mesh, [device] * world,
                                        backend="gloo", **kw)

            eager, comp, plain = make(compiled=False), make(), make(use_tp_cuda=False)
            outs = [comp.run(f) for f in feeds]
            first = {k: v.clone() for k, v in outs[0].items()}
            ptrs = {v.untyped_storage().data_ptr() for o in outs[1:] for v in o.values()}
            runs.append({
                "mesh": (dp, tp),
                "compiled": [{k: v.cpu().numpy() for k, v in o.items()} for o in outs],
                "eager": [{k: v.cpu().numpy() for k, v in eager.run(f).items()}
                          for f in feeds],
                "plain": {k: v.cpu().numpy() for k, v in plain.run(feeds[0]).items()},
                "first_unchanged": all(torch.equal(first[k], outs[0][k]) for k in first),
                "first_unshared": not any(v.untyped_storage().data_ptr() in ptrs
                                          for v in outs[0].values()),
                "n_segments": comp.n_segments, "eager_segments": eager.n_segments,
                "n_graphs": comp.n_graphs,
                "input_shapes": comp.input_shapes,
                "n_tp_ops": comp.n_tp_ops, "n_split_ops": comp.n_split_ops,
                "plain_tp_ops": plain.n_tp_ops,
                "plain_tags": sorted({op.attrs.get("kernel") or "torch"
                                      for op in plain.graph.ops})})
        by_graph.append(runs)
    return by_graph


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


def _bits(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


def reading_requests(run_once, device: torch.device, least: int, window_s: float) -> int:
    """The requests that fill a reading of `window_s` seconds: `least`
    timed on this rank (after a sync and a barrier), then the count that
    rate gives for 1.1 windows, timed again until a timed run lasts a
    window.  Every rank runs the count rank 0 finds, as a request's
    collectives pair the ranks."""
    import math
    import time

    import torch.distributed as dist

    n = least
    while True:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            run_once()
        _sync(device)
        secs = time.perf_counter() - t0
        step = [secs >= window_s, max(n + 1, math.ceil(1.1 * window_s * n / secs))]
        if dist.is_initialized():
            dist.broadcast_object_list(step, src=0)
        if step[0]:
            return n
        n = step[1]


def sharded_requests(graph, feeds: Sequence[Dict[str, np.ndarray]],
                     meshes: Sequence[Tuple[int, int]], device: str, backend: str,
                     reading: Tuple[int, float], predictor_turns: bool = False) -> List[dict]:
    """`graph` (optimized) through :class:`ShardedPredictor` at each mesh
    of `meshes` on this rank, eager and compiled.  The eager one
    (``compiled=False``): one request on ``feeds[0]`` counted (launches
    from 0 just before it, read just after), and rank 0 holds every int8
    intermediate (gathered over the data group) against the single-device
    eager loop's on the same card: elements that differ and by how much.
    The compiled one: warmed up on ``feeds[0]``, its launches counted at
    the capture, its CUDA graphs and segments; its output on each feed
    against the eager one's, bit for bit, the first left unchanged by the
    second; no launch on a replay.  Then img/s in turns (eager, compiled,
    compiled, eager) on ``feeds[0]``, timed between barriers (rank 0's host
    clock); `reading` is (least requests, seconds): each predictor's
    readings run the count of requests that filled that window, at least
    `least` (:func:`reading_requests`).  With `predictor_turns` (a 1x1
    mesh) also the single-device ``Predictor`` against the compiled one
    (Predictor, compiled, compiled, Predictor)."""
    import time

    import torch.distributed as dist

    from ..core.executor import build_callable, stage_weights
    from ..runtime.predictor import Predictor

    dev = torch.device(device)
    world = dist.get_world_size()
    batch = graph.vars[graph.inputs[0]].shape[0]
    on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    least, window_s = reading
    out = []
    for dp, tp in meshes:
        mesh = MeshConfig(data=dp, model=tp)
        g = copy.deepcopy(graph)
        name = g.outputs[0]
        seen: Dict[str, torch.Tensor] = {}

        def capture(n, value):
            if value.dtype == torch.int8:
                seen[n] = value

        sp = ShardedPredictor(g, mesh, [device] * world, backend=backend, compiled=False,
                              capture=capture)
        sp.run(feeds[0])  # warm-up: per-op constants, libraries
        _sync(dev)
        _reset_counts()
        eager_out = [sp.run(feeds[0])[name]]
        _sync(dev)
        counts = _counts()
        ints = {}
        for n in sorted(seen):
            v = seen[n]
            ints[n] = sp.mesh.all_gather(v, "data", dim=0) if n in sp.batch_vars else v
        eager_out += [sp.run(f)[name] for f in feeds[1:]]
        seen.clear()

        cp = ShardedPredictor(copy.deepcopy(graph), mesh, [device] * world, backend=backend)
        cp.warm_up(feeds[0])
        _sync(dev)
        _reset_counts()
        if dev.type == "cuda":  # on the CPU there is no CUDA graph to capture
            cp.capture()
        _sync(dev)
        at_capture = _counts()
        got = [cp.run(feeds[0])[name]]
        kept = got[0].clone()
        got += [cp.run(f)[name] for f in feeds[1:]]
        _sync(dev)
        compiled = {"launches_at_capture": at_capture, "replay_launches": {
                        k: v - at_capture[k] for k, v in _counts().items()},
                    "n_graphs": cp.n_graphs, "n_segments": cp.n_segments,
                    "equal_to_eager": [_bits(a) == _bits(b) for a, b in zip(got, eager_out)],
                    "first_unchanged": _bits(got[0]) == _bits(kept),
                    "outs": [o.cpu().numpy() for o in got]}

        preds = {"eager": sp, "compiled": cp}
        if predictor_turns:
            preds["predictor"] = Predictor(copy.deepcopy(graph), device=dev)
            for f in feeds:  # warm-up and capture; both pinned staging buffers made
                preds["predictor"].run(f)
        n_req = {k: reading_requests(lambda p=p: p.run(feeds[0]), dev, least, window_s)
                 for k, p in preds.items()}

        def img_s(which) -> float:
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n_req[which]):
                preds[which].run(feeds[0])
            _sync(dev)
            return batch * n_req[which] / (time.perf_counter() - t0)

        turns = {"eager": [], "compiled": []}
        for which in ("eager", "compiled", "compiled", "eager"):
            turns[which].append(img_s(which))
        if predictor_turns:
            turns["predictor"], turns["compiled_vs_predictor"] = [], []
            for which in ("predictor", "compiled", "compiled", "predictor"):
                key = "predictor" if which == "predictor" else "compiled_vs_predictor"
                turns[key].append(img_s(which))
        preds.clear()
        compiled["img_s_in_turns"] = turns
        row = {"mesh": [dp, tp], "backend": sp.mesh.backend, "launches": counts,
               "n_tp_ops": sp.n_tp_ops, "n_split_ops": sp.n_split_ops,
               "requests": n_req, "out": eager_out[0].cpu().numpy(), "compiled": compiled}
        if dist.get_rank() == 0:  # the single-device eager loop, same card, same graph
            ref: Dict[str, torch.Tensor] = {}
            one = copy.deepcopy(graph)
            fn = build_callable(one, device=dev, capture=lambda n, v: ref.__setitem__(n, v)
                                if v.dtype == torch.int8 else None)
            with on_card:
                fn(stage_weights(one, dev), feeds[0])
            diffs = {}
            for n, v in ints.items():
                d = (v.to(torch.int32) - ref[n].to(torch.int32)).abs()
                diffs[n] = {"numel": v.numel(), "n_diff": int((d > 0).sum()),
                            "max_diff": int(d.max()) if v.numel() else 0}
            row["int8_diffs"] = diffs
        ints.clear()
        out.append(row)
        del sp, cp
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def card_ranks(graph, feeds: Sequence[Dict[str, np.ndarray]],
               meshes: Sequence[Tuple[int, int]], backend: str, reading: Tuple[int, float],
               device: str = "cuda:0", pair: Tuple[int, int, int] = None,
               predictor_turns: bool = False) -> dict:
    """One rank of ``chip_smoke.py``'s phase 17, every rank on `device`
    (the one card): the FFN pair (where `pair` gives its M, hidden, FFN)
    and the sharded requests, eager and compiled."""
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    res = {}
    if pair is not None:
        res["pair"] = ffn_pair(*pair, seed=0, device=device)
    res["sharded"] = sharded_requests(graph, feeds, meshes, device, backend, reading,
                                      predictor_turns)
    return res
