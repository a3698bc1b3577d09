"""Checkpoint backend — the port's counterpart of
``paddle_lite_tpu/formats/orbax_ckpt.py`` (``:1-49``).

The reference saves the optimized graph's weight pytree through
``orbax.checkpoint``, so that JAX-ecosystem tools can read it, with the
graph meta beside it as JSON.  Orbax is a JAX library and the port imports
no JAX, so the PyTorch ecosystem's own form stands in for it: a directory
holding ``graph.json`` (``artifact.graph_to_meta``, the same JSON the
``nbf`` artifact carries) and ``weights.pt``, a ``torch.save`` state dict of
the weights (int8 tensors, per-channel scales in the meta, packed W4 as
stored).  ``load`` reads them back with ``torch.load(weights_only=True)``,
which unpickles tensors and nothing else, and ``graph_from_meta``.  The
deployment format stays the ``nbf`` artifact (``formats/artifact.py``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.ir import Graph
from .artifact import graph_from_meta, graph_to_meta

GRAPH, WEIGHTS = "graph.json", "weights.pt"


def save(graph: Graph, path: str) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, GRAPH), "w") as f:
        json.dump(graph_to_meta(graph), f)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in graph.weights.items()}, os.path.join(path, WEIGHTS))


def load(path: str) -> Graph:
    path = os.path.abspath(path)
    with open(os.path.join(path, GRAPH)) as f:
        g = graph_from_meta(json.load(f))
    weights = torch.load(os.path.join(path, WEIGHTS), weights_only=True)
    g.weights = {k: v.numpy() for k, v in weights.items()}
    g.rebuild_links()
    return g
