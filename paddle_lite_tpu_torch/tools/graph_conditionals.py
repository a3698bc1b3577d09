"""Conditional CUDA graph nodes on the card: what the installed torch
offers.

Prints one JSON line: the torch and CUDA versions, the driver, the card
and its power limit, and whether ``torch.cuda.CUDAGraph`` has
``begin_capture_to_if_node``, ``end_capture_to_conditional_node`` and
``get_currently_capturing_graph`` (the calls with which
``torch._higher_order_ops.cudagraph_conditional_nodes`` captures
``torch.cond`` under an IF node).  Where it has them, a two-op toy is
captured under one IF node and replayed with the predicate true and then
false; the script exits 1 where it has not.  Without them no control flow
can run inside one CUDA graph through torch, which is why the compiled
predictor and the loaded program read their conditions on the host
between replays (``core/executor._While``, ``formats/aot._ControlFlow``).

Run on the card: ``python3 -m paddle_lite_tpu_torch.tools.graph_conditionals``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess

import torch

CALLS = ("begin_capture_to_if_node", "end_capture_to_conditional_node",
         "get_currently_capturing_graph")


def _nvsmi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()


def offered() -> dict:
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "driver": _nvsmi("driver_version"), "card": _nvsmi("name,power.limit"),
            "calls": {c: hasattr(torch.cuda.CUDAGraph, c) for c in CALLS}}


@contextlib.contextmanager
def _if(pred: torch.Tensor):
    graph = torch.cuda.CUDAGraph.get_currently_capturing_graph()
    graph.begin_capture_to_if_node(pred)
    try:
        yield
    finally:
        graph.end_capture_to_conditional_node()


def toy() -> dict:
    """y <- 2x + 1 under one IF node: replayed with the predicate true,
    then false (y set to -1 first, and left so)."""
    dev = torch.device("cuda")
    x = torch.arange(4.0, device=dev)
    y = torch.full((4,), -1.0, device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    (x * 2.0 + 1.0).sum()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with _if(pred):
            y.copy_(x * 2.0 + 1.0)
    out = {}
    for flag in (True, False):
        y.fill_(-1.0)
        pred.fill_(flag)
        g.replay()
        torch.cuda.synchronize()
        out[str(flag).lower()] = y.tolist()
    out["ok"] = out["true"] == [1.0, 3.0, 5.0, 7.0] and out["false"] == [-1.0] * 4
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("graph_conditionals: no CUDA device")
    res = {"offered": offered()}
    missing = [c for c, ok in res["offered"]["calls"].items() if not ok]
    if not missing:
        res["toy"] = toy()
    print(json.dumps(res))
    if missing or not res["toy"]["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
