"""The parallel layer: sharded inference over ``torch.distributed`` ranks.

Port of ``paddle_lite_tpu/parallel/``: :class:`MeshConfig` and
:class:`ShardedPredictor` (``sharding``), the tensor-parallel int8 GEMM on
kernel 1 (``tp_cuda``), its op impls and retag (``tp_ops``), the
process-group runtime (``distributed``), the weak-scaling bench
(``scaling_bench``) and the multi-device dry run (``dryrun``).  Importing
it registers nothing in ``core.registry.OPS``.
"""

from .sharding import MeshConfig, ShardedPredictor, shard_inputs, shard_weights

__all__ = ["MeshConfig", "ShardedPredictor", "shard_inputs", "shard_weights"]
