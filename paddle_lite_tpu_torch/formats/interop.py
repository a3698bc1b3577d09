"""Graphs carried across from the JAX package.

:func:`graph_from_reference` takes what the reference's
``artifact.graph_to_meta(graph)`` returns (plain JSON types) plus the graph's
weights as numpy arrays, and gives the identical graph here — ops, attrs,
scales and int8 weights — with the reference's kernel tags translated:
``"xla"`` → ``"torch"`` and ``"pallas"`` → ``"cuda"``.  That is how a test
optimizes with the JAX package and runs the same optimized graph through the
port.  The JSON half lives in ``formats/artifact.py``, which reads and
writes the same meta in the ``nbf`` file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.ir import Graph
from .artifact import graph_from_meta


def graph_from_reference(meta: dict, weights: Dict[str, np.ndarray]) -> Graph:
    """The reference's ``graph_to_meta(graph)`` + ``graph.weights`` → Graph."""
    g = graph_from_meta(meta)
    g.weights = {k: np.array(v, copy=True) for k, v in weights.items()}
    g.rebuild_links()
    return g
